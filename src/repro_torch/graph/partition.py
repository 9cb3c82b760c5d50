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

The hub layout of ``repro.graph.partition`` (replicated hub rows for the
mesh-sharded walk) belongs to the sharded engine and is not ported here.
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
