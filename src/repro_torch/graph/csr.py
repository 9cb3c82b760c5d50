"""CSR graph storage as PyTorch tensors.

The paper stores graphs in CSR (Table II reports "Size (of CSR)").  Same
layout as ``repro.graph.csr``: ``indptr`` (V+1), ``indices`` (E), ``weights``
(E), built host-side in numpy and then placed on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Raises when CUDA is asked for and there is no card — an
    entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row graph.

    indptr:  (V+1,) int32 — neighbor list offsets.
    indices: (E,)   int32 — neighbor vertex ids, sorted ascending per row.
    weights: (E,)   float32 — edge weights (all-ones if unweighted).

    ``uid`` names the graph's contents: :meth:`to` keeps it, so the
    selection-plan cache (``core.methods``) reuses one graph's tables on
    every device it is moved to.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor
    uid: object = dataclasses.field(default_factory=object, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @property
    def num_vertices(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def to(self, device) -> "CSRGraph":
        device = torch.device(device)
        if self.indices.device == device:
            return self
        return CSRGraph(
            self.indptr.to(device), self.indices.to(device), self.weights.to(device),
            uid=self.uid,
        )

    def max_degree(self) -> int:
        return int((self.indptr[1:] - self.indptr[:-1]).max())


def csr_from_arrays(indptr, indices, weights, device="cuda") -> CSRGraph:
    """Wrap host CSR arrays (for example a ``repro`` graph's arrays taken
    with ``np.asarray``) as the port's graph on ``device``.  The arrays are
    copied bit for bit: int32 offsets and ids, float32 weights."""
    dev = resolve_device(device)
    return CSRGraph(
        indptr=torch.tensor(np.asarray(indptr, dtype=np.int32), device=dev),
        indices=torch.tensor(np.asarray(indices, dtype=np.int32), device=dev),
        weights=torch.tensor(np.asarray(weights, dtype=np.float32), device=dev),
    )


def csr_from_edges(
    num_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
    symmetrize: bool = False,
    dedup: bool = True,
    device="cuda",
) -> CSRGraph:
    """Build a CSRGraph from an edge list (host-side numpy, the same code as
    ``repro.graph.csr_from_edges``, then ``device``)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if weights is None:
        w = np.ones(src.shape[0], dtype=np.float32)
    else:
        w = np.asarray(weights, dtype=np.float32)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    # Remove self loops.
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    if dedup and src.size:
        uniq = np.ones(src.shape[0], dtype=bool)
        uniq[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst, w = src[uniq], dst[uniq], w[uniq]
    counts = np.bincount(src, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return csr_from_arrays(indptr, dst, w, device=device)


def degrees(graph: CSRGraph) -> torch.Tensor:
    """Each vertex's out-degree, (V,) int32 on the graph's device."""
    return graph.indptr[1:] - graph.indptr[:-1]


def neighbors_padded(
    graph: CSRGraph, vertices: torch.Tensor, max_degree: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded neighbor lists of a batch of vertices (all ``>= 0``).

    Returns ``(neighbors, weights, mask)``, each ``vertices.shape +
    (max_degree,)``; padded slots hold neighbor -1, weight 0, mask False.
    Degrees above ``max_degree`` are truncated.
    """
    v = vertices.long()
    start = graph.indptr[v].long()
    deg = graph.indptr[v + 1].long() - start
    offs = torch.arange(max_degree, device=v.device)
    mask = offs < deg[..., None]
    safe = torch.where(mask, start[..., None] + offs, 0)
    nbrs = torch.where(mask, graph.indices[safe], -1)
    wts = torch.where(mask, graph.weights[safe], 0.0)
    return nbrs, wts, mask
