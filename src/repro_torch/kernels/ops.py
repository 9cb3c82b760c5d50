"""Key-taking wrappers around the kernels: ``repro.kernels.ops``.

Each draws its own uniforms from a key, as ``repro``'s does, and runs the
port's kernel on a CUDA tensor or its plain version on a CPU tensor: the
same key gives the same result as ``repro.kernels.ops``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import its_select as _its_select
from repro_torch.kernels import walk_step as _walk_step
from repro_torch.kernels.threefry import uniform


def its_select(key, biases: torch.Tensor, k: int, *, iters: int = 8) -> torch.Tensor:
    """Without-replacement ITS+BRS selection of ``k`` of P candidates.

    key: a ``uint32[2]`` key; biases: (I, P) float32.  Draws the retry
    budget ``uniform(key, (I, iters, k))``; returns (I, K) int32 indices,
    -1 where unfilled.
    """
    rands = uniform(key, (biases.shape[0], iters, k), device=biases.device)
    idx, _ = _its_select(biases, rands)
    return idx


def walk_step(key, graph: CSRGraph, cur: torch.Tensor, *, max_seg: int = 512) -> torch.Tensor:
    """One weighted random-walk step for all walkers: ``walk_step``'s ITS
    pick in one segment of ``max_seg`` (128, 256, 384 or 512).

    Requires max degree <= max_seg (a longer row is cut to its first
    ``max_seg`` entries).  key: a ``uint32[2]`` key, the walkers' uniforms
    ``uniform(key, (W,))``; cur: (W,) int32 on the graph's device (-1 =
    finished walker).  Returns next (W,) int32, -1 at a dead end.
    """
    return _walk_step(np.asarray(key, dtype=np.uint32), graph.indptr, graph.indices,
                      graph.weights, cur, buckets=(max_seg,), use_chunked=False,
                      methods=("its",), key_path=())
