"""Contiguous vertex-range graph partitioning (paper §V-A).

The same partitioning as ``repro.graph.partition``: each partition owns a
contiguous, equal range of vertices with all their neighbor lists (sampling
needs every edge of a vertex to compute its transition probabilities), and
membership is O(1) arithmetic (``vertex // range_size``), which the
workload-aware scheduler relies on.  A :class:`RangePartition` is host
numpy, equal array for array to ``repro``'s.

Device residency uses the compact local-id layout: a resident partition's
``indptr`` covers its own vertex range plus one phantom row of degree 0,
never the full vertex space.  Queue entries keep global vertex ids; the
rebase offset ``vertex_lo`` translates at the partition boundary.

The hub half (:func:`select_hubs`, :func:`hub_edge_layout`,
:func:`hybrid_host_csr`, :func:`place_hub_edges`, :func:`localize_hybrid`)
is the sharded walk's layout: the top-degree rows, budgeted in bytes, are
replicated on every shard beside its compact range, each at an edge offset
congruent to its global one modulo the widest window, so a pick off a
replicated row is bit-identical to the owner's.  The first four build host
numpy arrays equal to ``repro``'s; the copies of the hub rows are placed
with one vectorized gather where ``repro`` loops over the hubs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph, resolve_device


@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """Cached contiguous-range bounds and O(1) partition lookup.

    ``range_size = ceil(V / P)`` and ``pid(v) = min(v // range_size, P - 1)``.
    """

    num_vertices: int
    num_partitions: int
    range_size: int
    bounds: np.ndarray  # (P+1,) int64 vertex range boundaries

    @staticmethod
    @functools.lru_cache(maxsize=128)
    def create(num_vertices: int, num_partitions: int) -> "PartitionMap":
        rs = -(-num_vertices // num_partitions)  # ceil
        bounds = np.minimum(np.arange(num_partitions + 1, dtype=np.int64) * rs, num_vertices)
        bounds.setflags(write=False)  # the cache shares this array
        return PartitionMap(num_vertices, num_partitions, rs, bounds)

    def pid_of(self, vertex) -> np.ndarray:
        """O(1) host-side lookup."""
        v = np.asarray(vertex)
        return np.clip(v // self.range_size, 0, self.num_partitions - 1)

    def pid_of_device(self, vertex: torch.Tensor) -> torch.Tensor:
        """The same lookup as tensor arithmetic on the vertices' device."""
        return pid_of_device(vertex, self.range_size, self.num_partitions)


def pid_of_device(vertex: torch.Tensor, range_size: int, num_partitions: int) -> torch.Tensor:
    """``min(v // range_size, P - 1)`` (floor division, clipped at 0) as
    int32 tensor arithmetic: the drain's cross-partition routing."""
    pid = torch.div(vertex, range_size, rounding_mode="floor")
    return torch.clamp(pid, 0, num_partitions - 1).to(torch.int32)


def partition_of(vertex, num_vertices: int, num_partitions: int):
    """O(1) partition lookup through the cached :class:`PartitionMap`."""
    return PartitionMap.create(num_vertices, num_partitions).pid_of(vertex)


@dataclasses.dataclass
class DevicePartition:
    """A device-resident compact partition CSR (local ids and a phantom row).

    ``graph`` is a local-id CSR: row ``i`` holds vertex ``vertex_lo + i``,
    and one extra phantom row of degree 0 at local id
    ``num_local_vertices`` absorbs every neighbor outside the partition.
    ``graph.indices`` hold local ids; ``indices_global`` holds the global
    neighbor ids, aligned edge for edge, for the walk's output and the
    cross-partition queue pushes.
    """

    graph: CSRGraph
    indices_global: torch.Tensor  # (E_P,) int32 global neighbor ids
    vertex_lo: int
    vertex_hi: int

    @property
    def num_local_vertices(self) -> int:
        """Rows excluding the phantom row (padding rows included)."""
        return self.graph.num_vertices - 1

    @property
    def nbytes(self) -> int:
        """The bytes a transfer ships: local indptr, local indices, weights
        and global indices, in their dtypes."""
        g = self.graph
        return sum(t.numel() * t.element_size()
                   for t in (g.indptr, g.indices, g.weights, self.indices_global))

    def localize(self, x: torch.Tensor) -> torch.Tensor:
        """Global vertex ids to this partition's row ids: ids outside the
        resident range (-1 padding included) map to the degree-0 phantom
        row, so any localized id is safe for row lookups on ``graph``."""
        nloc = self.num_local_vertices
        inside = (x >= self.vertex_lo) & (x < self.vertex_lo + nloc)
        return torch.where(inside, x - self.vertex_lo, nloc).to(torch.int32)


@dataclasses.dataclass
class RangePartition:
    """One partition: vertices [vertex_lo, vertex_hi) with their full rows,
    as host numpy arrays."""

    pid: int
    vertex_lo: int
    vertex_hi: int
    # local CSR over the owned vertex range: indptr re-based to 0, indices
    # global vertex ids (edges may point into any partition)
    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    # global offset of the partition's first edge in the source CSR
    edge_lo: int = 0
    #: names the partition's contents, for host caches keyed on it
    uid: object = dataclasses.field(default_factory=object, compare=False, repr=False)

    @property
    def num_vertices(self) -> int:
        return self.vertex_hi - self.vertex_lo

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def local_arrays(self, pad_vertices: Optional[int] = None, pad_edges: Optional[int] = None,
                     edge_align: int = 0) -> tuple:
        """The compact local CSR as host arrays ``(indptr, indices_local,
        indices_global, weights)``, as ``repro``'s ``to_local_device_csr``
        builds them.

        ``pad_vertices`` / ``pad_edges`` round the arrays up to a common
        shape (padding rows have degree 0, padding edges weight 0 and global
        id -1).  ``edge_align > 0`` prepends ``edge_lo % edge_align`` inert
        edges, so every row keeps its global offset modulo ``edge_align``
        (the ITS windows count their scan blocks from ``start // seg ·
        seg``).
        """
        nv = self.num_vertices
        lead = (self.edge_lo % edge_align) if edge_align > 0 else 0
        pv = max(pad_vertices or nv, nv)
        pe = max(pad_edges or (lead + self.num_edges), lead + self.num_edges)
        indptr = np.empty(pv + 2, dtype=np.int32)  # pv rows + the phantom row
        indptr[: nv + 1] = self.indptr + lead
        indptr[nv + 1:] = self.indptr[-1] + lead
        u_loc = self.indices.astype(np.int64) - self.vertex_lo
        in_part = (u_loc >= 0) & (u_loc < nv)
        indices_local = np.where(in_part, u_loc, pv).astype(np.int32)
        epad = pe - self.num_edges - lead
        indices_local = np.pad(indices_local, (lead, epad), constant_values=pv)
        indices_global = np.pad(self.indices.astype(np.int32), (lead, epad), constant_values=-1)
        weights = np.pad(self.weights.astype(np.float32), (lead, epad))
        return indptr, indices_local, indices_global, weights

    def to_local_device_csr(self, pad_vertices: Optional[int] = None,
                            pad_edges: Optional[int] = None, edge_align: int = 0,
                            device="cuda") -> DevicePartition:
        """The compact O(V/P + E_P) CSR of :meth:`local_arrays` on
        ``device`` (``cuda`` unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        indptr, il, ig, w = (torch.from_numpy(a).to(dev)
                             for a in self.local_arrays(pad_vertices, pad_edges, edge_align))
        return device_partition(indptr, il, ig, w, self.vertex_lo, self.vertex_hi)


def device_partition(indptr, indices_local, indices_global, weights, vertex_lo: int,
                     vertex_hi: int) -> DevicePartition:
    """A :class:`DevicePartition` over arrays already on their device."""
    return DevicePartition(
        graph=CSRGraph(indptr=indptr, indices=indices_local, weights=weights),
        indices_global=indices_global, vertex_lo=int(vertex_lo), vertex_hi=int(vertex_hi),
    )


def partition_by_vertex_range(graph: CSRGraph, num_partitions: int) -> List[RangePartition]:
    """Split a graph into ``num_partitions`` contiguous vertex ranges, as
    host partitions (the graph's arrays are read back from its device)."""
    indptr = graph.indptr.cpu().numpy()
    indices = graph.indices.cpu().numpy()
    weights = graph.weights.cpu().numpy()
    n = indptr.shape[0] - 1
    bounds = PartitionMap.create(n, num_partitions).bounds
    parts: List[RangePartition] = []
    for pid in range(num_partitions):
        lo, hi = int(bounds[pid]), int(bounds[pid + 1])
        e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
        parts.append(RangePartition(
            pid=pid, vertex_lo=lo, vertex_hi=hi,
            indptr=(indptr[lo:hi + 1] - indptr[lo]).astype(np.int32),
            indices=indices[e_lo:e_hi].copy(), weights=weights[e_lo:e_hi].copy(), edge_lo=e_lo,
        ))
    return parts


# ---------------------------------------------------------------------------
# The hub half: replicated hub rows for the sharded walk (``shard.walk``)
# ---------------------------------------------------------------------------


def select_hubs(indptr: np.ndarray, hub_bytes: int, seg_big: int, min_degree: int = 2,
                bytes_per_edge: int = 28) -> np.ndarray:
    """The top-degree *hub* rows that fit a per-shard byte budget.

    Rows are taken greedily by descending degree (stable on ties) until the
    cumulative replicated footprint exceeds ``hub_bytes``; each hub costs
    ``(degree + seg_big) * bytes_per_edge`` (``seg_big``: the worst-case
    alignment lead :func:`hub_edge_layout` may insert; ``bytes_per_edge``:
    the seven per-edge int32/f32 lanes the drain replicates).  Rows of
    degree below ``min_degree`` are never replicated.  Returns the hub
    vertex ids sorted ascending (int64), as ``repro``'s.
    """
    deg = np.diff(np.asarray(indptr)).astype(np.int64)
    if hub_bytes <= 0:
        return np.empty(0, dtype=np.int64)
    order = np.argsort(-deg, kind="stable")
    cost = np.cumsum((deg[order] + max(seg_big, 0)) * bytes_per_edge)
    take = int(np.searchsorted(cost, hub_bytes, side="right"))
    hubs = order[:take]
    hubs = hubs[deg[hubs] >= min_degree]
    return np.sort(hubs).astype(np.int64)


def hub_edge_layout(indptr: np.ndarray, hubs: np.ndarray, hub_region_lo: int,
                    seg_big: int) -> tuple:
    """Alignment-preserving placement of the replicated hub rows' edges.

    Hub ``s``'s edges start at ``starts[s]``, with ``starts[s] % seg_big ==
    indptr[hubs[s]] % seg_big``, placed in turn from ``hub_region_lo`` with
    at most ``seg_big - 1`` junk edges between hubs.  Every shard computes
    the same layout.  Returns ``(starts, end)``: int64 ``(H,)`` and the
    first unused edge slot.
    """
    hubs = np.asarray(hubs)
    starts = np.empty(hubs.shape[0], dtype=np.int64)
    cur = int(hub_region_lo)
    for s, h in enumerate(hubs):
        g = int(indptr[h])
        lead = (g - cur) % seg_big if seg_big > 0 else 0
        starts[s] = cur + lead
        cur = int(starts[s]) + int(indptr[h + 1] - indptr[h])
    return starts, cur


def _hub_edges(indptr_full: np.ndarray, hubs: np.ndarray, hub_starts: np.ndarray):
    """``(src, dst)`` int64: each hub edge's position in the full graph and
    in the hybrid layout, hub after hub."""
    hubs = np.asarray(hubs, dtype=np.int64)
    g0 = np.asarray(indptr_full, dtype=np.int64)[hubs]
    deg = np.asarray(indptr_full, dtype=np.int64)[hubs + 1] - g0
    off = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(np.cumsum(deg) - deg, deg)
    return (np.repeat(g0, deg) + off,
            np.repeat(np.asarray(hub_starts, dtype=np.int64), deg) + off)


def hybrid_host_csr(part: RangePartition, pad_vertices: int, pad_edges: int, edge_align: int,
                    hubs: np.ndarray, hub_starts: np.ndarray, indptr_full: np.ndarray,
                    indices_full: np.ndarray, weights_full: np.ndarray) -> tuple:
    """Host arrays of one shard's hub-replicated *hybrid* layout.

    Row space (``pv = pad_vertices`` resident rows, ``H`` hubs)::

        rows 0 .. pv-1        resident local rows (padding rows degree 0)
        row  pv               bridge junk row (never addressed)
        row  pv + 1 + 2s      hub s (its edges at hub_starts[s])
        row  pv + 2 + 2s      junk gap row after hub s
        row  pv + 2H          phantom sink (degree 0)

    so ``indptr`` has ``pv + 2H + 2`` entries.  The edge arrays hold the
    resident region (lead-padded to keep each row's global offset modulo
    ``edge_align``) and then the hub region; gaps carry local index
    ``phantom``, global index -1 and weight 0.  Returns ``(indptr,
    indices_local, indices_global, weights)``, equal to ``repro``'s.
    """
    nv = part.num_vertices
    lead = (part.edge_lo % edge_align) if edge_align > 0 else 0
    pv = max(pad_vertices, nv)
    hubs = np.asarray(hubs, dtype=np.int64)
    num_hubs = int(hubs.shape[0])
    phantom = pv + 2 * num_hubs
    end_local = lead + part.num_edges
    pe = max(pad_edges, end_local)
    deg_full = np.diff(np.asarray(indptr_full)).astype(np.int64)
    hub_deg = deg_full[hubs]
    if num_hubs:
        pe = max(pe, int(hub_starts[-1]) + int(hub_deg[-1]))

    indptr = np.empty(phantom + 2, dtype=np.int32)
    indptr[: nv + 1] = part.indptr + lead
    indptr[nv + 1: pv + 1] = end_local
    hub_ends = np.asarray(hub_starts, dtype=np.int64) + hub_deg
    indptr[pv + 1: phantom: 2] = hub_starts
    indptr[pv + 2: phantom + 1: 2] = hub_ends
    end = int(hub_ends[-1]) if num_hubs else end_local
    indptr[phantom] = end
    indptr[phantom + 1] = end

    indices_local = np.full(pe, phantom, dtype=np.int32)
    indices_global = np.full(pe, -1, dtype=np.int32)
    weights = np.zeros(pe, dtype=np.float32)

    def local_ids(u):
        u_loc = u.astype(np.int64) - part.vertex_lo
        return np.where((u_loc >= 0) & (u_loc < nv), u_loc, phantom).astype(np.int32)

    indices_local[lead:end_local] = local_ids(part.indices)
    indices_global[lead:end_local] = part.indices.astype(np.int32)
    weights[lead:end_local] = part.weights.astype(np.float32)
    if num_hubs:
        src, dst = _hub_edges(indptr_full, hubs, hub_starts)
        hub_u = np.asarray(indices_full)[src]
        indices_local[dst] = local_ids(hub_u)
        indices_global[dst] = hub_u.astype(np.int32)
        weights[dst] = np.asarray(weights_full)[src].astype(np.float32)
    return indptr, indices_local, indices_global, weights


def place_hub_edges(base: np.ndarray, full: np.ndarray, indptr_full: np.ndarray,
                    hubs: np.ndarray, hub_starts: np.ndarray) -> np.ndarray:
    """A copy of ``base`` (a per-edge lane's resident region and gap fill)
    with each hub row's slice of the full-graph lane ``full`` placed at its
    :func:`hub_edge_layout` offset: the bias, alias and target-degree lanes,
    which the drain must read alike whether a row is resident or a hub."""
    out = np.asarray(base).copy()
    if np.asarray(hubs).shape[0]:
        src, dst = _hub_edges(indptr_full, hubs, hub_starts)
        out[dst] = np.asarray(full)[src]
    return out


def localize_hybrid(x: torch.Tensor, vertex_lo: int, num_rows: int, hubs: torch.Tensor,
                    num_hubs: int) -> torch.Tensor:
    """Global vertex ids to hybrid row ids (resident, hub or phantom).

    Ids in the resident range rebase to rows ``0 .. num_rows-1`` (the
    resident copy wins when a hub is also resident: both pick alike); ids
    of a replicated hub (a binary search of the sorted ``hubs``) map to row
    ``num_rows + 1 + 2·pos``; anything else, -1 padding included, maps to
    the degree-0 phantom row ``num_rows + 2·num_hubs``.  ``row != phantom``
    is the drain's stay-local test.  int32, on ``x``'s device.
    """
    phantom = num_rows + 2 * num_hubs
    inside = (x >= vertex_lo) & (x < vertex_lo + num_rows)
    loc = torch.where(inside, x - vertex_lo, phantom).to(torch.int32)
    if num_hubs:
        pos = torch.searchsorted(hubs, x.to(hubs.dtype).contiguous())
        posc = torch.clamp(pos, 0, num_hubs - 1)
        is_hub = (pos < num_hubs) & (hubs[posc] == x)
        hub_row = (num_rows + 1 + 2 * posc).to(torch.int32)
        loc = torch.where(inside, loc, torch.where(is_hub, hub_row, phantom)).to(torch.int32)
    return loc
