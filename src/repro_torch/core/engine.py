"""C-SAW random-walk engine (paper Fig. 2(b) MAIN loop), flat-bias path.

``random_walk`` runs one step per loop iteration for all instances at once
(the paper's inter-warp parallelism is the walker dimension).  The spec is
lowered to its transition program; the host plans one selection method per
degree cohort, and every step runs ``core.backend.walk_step_adaptive`` —
CUDA kernels on the card, their plain versions on the CPU — with the
reference's counted RNG, so the walks equal ``repro``'s bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import backend as bk
from repro_torch.core import methods as mt
from repro_torch.core import transition as tp
from repro_torch.core.api import SamplingSpec
from repro_torch.core.rng import fold_in, key_from_array
from repro_torch.graph.csr import CSRGraph, resolve_device


class WalkResult(NamedTuple):
    walks: torch.Tensor  # (I, depth+1) int32, -1 after termination
    lengths: torch.Tensor  # (I,) realized lengths (# vertices)
    sampled_edges: torch.Tensor  # () total sampled edges (for SEPS)


def flat_method_plan(
    graph: CSRGraph,
    program: tp.TransitionProgram,
    max_degree: int,
) -> tuple[tuple, mt.MethodTables]:
    """Host-side adaptive selection plan for a flat-bias program.

    Returns ``(methods, tables)``: the cost-model pick per degree cohort
    plus the prebuilt tables it needs (cached per (graph, bias fn)).  A
    forced ``method="its"`` gives the all-ITS plan and no tables.
    """
    buckets, use_chunked = bk.walk_bucket_plan(max_degree)
    n = len(buckets) + (1 if use_chunked else 0)
    if program.method == "its":
        return ("its",) * n, mt.EMPTY_TABLES
    override = None if program.method == "auto" else program.method
    return mt.plan_for_graph(
        graph, program.bias.fn, buckets=buckets, use_chunked=use_chunked,
        override=override,
    )


def random_walk(
    graph: CSRGraph,
    seeds,
    key,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
    device="cuda",
) -> WalkResult:
    """Run ``depth`` walk steps for every seed.

    ``key`` is a ``uint32[2]`` key (``core.rng.PRNGKey``, or a JAX key's raw
    words); step ``it`` draws from ``fold_in(fold_in(key, it), 1)``, as the
    reference.  ``max_degree`` bounds the degrees for the bucket plan (an
    understated bound truncates rows, it never kills walkers).  Seeds may be
    ``-1``: those instances are dead on arrival and emit all--1 rows.

    Runs on ``device`` — ``cuda`` unless the caller passes ``"cpu"``; the
    graph and seeds are moved there.

    Example — 4 unbiased walks of 3 steps on a 4-cycle, on the CPU:

    >>> from repro_torch.core import algorithms as alg
    >>> from repro_torch.core.rng import PRNGKey
    >>> from repro_torch.graph import csr_from_edges
    >>> g = csr_from_edges(4, [0, 1, 2, 3], [1, 2, 3, 0], symmetrize=True, device="cpu")
    >>> res = random_walk(g, [0, 1, 2, 3], PRNGKey(0), depth=3,
    ...                   spec=alg.deepwalk(), max_degree=2, device="cpu")
    >>> tuple(res.walks.shape), int(res.sampled_edges)
    ((4, 4), 12)
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    seeds = torch.as_tensor(seeds).to(device=dev, dtype=torch.int32)
    key = key_from_array(key)
    program = tp.lower(spec)
    methods, tables = flat_method_plan(graph, program, max_degree)
    flat_bias = program.bias.fn(graph)
    buckets, use_chunked = bk.walk_bucket_plan(max_degree)

    cur = seeds
    path = [seeds]
    for it in range(depth):
        kstep = fold_in(key, it)
        # identity epilogue: the selected neighbor, -1 for dead walkers
        cur = bk.walk_step_adaptive(
            fold_in(kstep, 1), graph.indptr, graph.indices, flat_bias, cur,
            buckets=buckets, use_chunked=use_chunked, methods=methods, tables=tables,
        )
        path.append(cur)
    walks = torch.stack(path, dim=1)
    lengths = (walks >= 0).sum(dim=-1, dtype=torch.int32)
    return WalkResult(walks, lengths, torch.clamp(lengths - 1, min=0).sum())
