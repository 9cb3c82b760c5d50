"""Synthetic graph generators (host-side numpy; deterministic by seed).

The same numpy code as ``repro.graph.generators``, so a seed gives identical
CSR arrays in both packages:

- ``rmat_graph``        — Graph500-style R-MAT (power-law, community structure).
- ``powerlaw_graph``    — configuration-model power-law degree sequence.
- ``erdos_renyi_graph`` — uniform-degree control.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, csr_from_edges


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    device="cuda",
) -> CSRGraph:
    """R-MAT generator (Graph500 parameters by default)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    w = rng.random(m).astype(np.float32) + 0.1 if weighted else None
    return csr_from_edges(n, src, dst, weights=w, symmetrize=True, device=device)


def erdos_renyi_graph(
    num_vertices: int, avg_degree: float, seed: int = 0, weighted: bool = False,
    device="cuda",
) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = int(num_vertices * avg_degree / 2)
    src = rng.integers(0, num_vertices, m)
    dst = rng.integers(0, num_vertices, m)
    w = rng.random(m).astype(np.float32) + 0.1 if weighted else None
    return csr_from_edges(num_vertices, src, dst, weights=w, symmetrize=True, device=device)


def powerlaw_graph(
    num_vertices: int,
    exponent: float = 2.1,
    min_degree: int = 2,
    max_degree: int | None = None,
    seed: int = 0,
    weighted: bool = False,
    device="cuda",
) -> CSRGraph:
    """Configuration-model graph with a power-law degree sequence."""
    rng = np.random.default_rng(seed)
    if max_degree is None:
        max_degree = max(min_degree + 1, int(np.sqrt(num_vertices)))
    # Inverse-CDF sampling of degrees ~ k^-exponent on [min_degree, max_degree]
    u = rng.random(num_vertices)
    a = 1.0 - exponent
    lo, hi = float(min_degree), float(max_degree)
    deg = ((lo**a + u * (hi**a - lo**a)) ** (1.0 / a)).astype(np.int64)
    stubs = np.repeat(np.arange(num_vertices, dtype=np.int64), deg)
    rng.shuffle(stubs)
    if stubs.size % 2:
        stubs = stubs[:-1]
    half = stubs.size // 2
    src, dst = stubs[:half], stubs[half:]
    w = rng.random(src.size).astype(np.float32) + 0.1 if weighted else None
    return csr_from_edges(num_vertices, src, dst, weights=w, symmetrize=True, device=device)
