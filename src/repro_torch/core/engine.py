"""C-SAW random-walk engine (paper Fig. 2(b) MAIN loop).

``random_walk`` runs one step per loop iteration for all instances at once
(the paper's inter-warp parallelism is the walker dimension).  The spec is
lowered to its transition program and each step dispatches on its mode, as
``repro.core.engine`` does:

- ``flat``   — ``core.backend.walk_step_adaptive``: one selection method per
  degree cohort, planned on the host (ITS, alias or rejection kernels);
- ``window`` — ``core.backend.walk_step_bucketed_window``: the dynamic hook
  (node2vec) evaluated on each cohort's row windows, the pick by the
  ``walk_step_window`` kernel;
- ``opaque`` — the dense ``(W, max_degree)`` context, the user's
  ``edge_bias`` hook, and the ITS draw by the ``its_select`` kernel.

Then the lowered epilogue (identity, MH, teleport, or the ``update`` hook).
CUDA kernels run on the card, their plain versions on the CPU, with the
reference's counted RNG, so the walks equal ``repro``'s bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import backend as bk
from repro_torch.core import methods as mt
from repro_torch.core import transition as tp
from repro_torch.core.api import EdgeCtx, SamplingSpec
from repro_torch.core.rng import fold_in, key_from_array, uniform
from repro_torch.graph.csr import CSRGraph, neighbors_padded, resolve_device

#: walkers per block of the opaque path's dense context: (block, max_degree)
#: tensors, not (W, max_degree) ones, at any W
GATHER_BLOCK = 1 << 18


class WalkResult(NamedTuple):
    walks: torch.Tensor  # (I, depth+1) int32, -1 after termination
    lengths: torch.Tensor  # (I,) realized lengths (# vertices)
    sampled_edges: torch.Tensor  # () total sampled edges (for SEPS)


def _degree(graph: CSRGraph, v: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(v, min=0).long()
    return torch.where(v >= 0, graph.indptr[safe + 1] - graph.indptr[safe], 0)


def _edge_ctx(graph: CSRGraph, v, prev, depth, max_degree, needs_prev_neighbors):
    """The dense EDGEBIAS context of a batch of walkers: ``(W, max_degree)``
    neighbor ids, weights and degrees, and — when asked — membership of
    each candidate in N(prev) by an O(D²) compare.  Returns ``(ctx, mask)``.
    """
    nbrs, wts, mask = neighbors_padded(graph, torch.clamp(v, min=0), max_degree)
    nbrs = torch.where((v >= 0)[:, None] & mask, nbrs, -1)
    mask = nbrs >= 0
    ipn = None
    if needs_prev_neighbors:
        pnbrs, _, pmask = neighbors_padded(graph, torch.clamp(prev, min=0), max_degree)
        pnbrs = torch.where((prev >= 0)[:, None] & pmask & (pnbrs >= 0), pnbrs, -2)
        ipn = (nbrs[:, :, None] == pnbrs[:, None, :]).any(dim=-1) & mask
    ctx = EdgeCtx(
        v=v, u=nbrs, weight=wts, deg_v=_degree(graph, v),
        deg_u=torch.where(mask, _degree(graph, nbrs), 0), prev=prev,
        is_prev_neighbor=ipn, depth=depth,
    )
    return ctx, mask


def _select_epilogue(key, graph, program, spec, v, prev, depth, u, home):
    """The post-select step of every mode: the minimal D = 1 EdgeCtx of the
    selected edge (unit ``weight`` placeholder, as the reference's fast
    paths) and the lowered epilogue under ``fold_in(key, 2)``."""
    if isinstance(program.epilogue, tp.IdentityEpilogue):
        return u  # the selected neighbor, -1 for dead walkers
    ctx = EdgeCtx(
        v=v, u=u[:, None], weight=torch.ones(u.shape + (1,), device=u.device),
        deg_v=_degree(graph, v), deg_u=_degree(graph, u)[:, None], prev=prev,
        is_prev_neighbor=None, depth=depth,
    )
    nxt = tp.apply_epilogue(fold_in(key, 2), program, spec, ctx, u, home)
    return torch.where(u >= 0, nxt, -1)


def _is_prev_neighbor_window(indptr, ids_sorted, prev, u, mask, *, steps: int):
    """Membership of window candidates in N(prev): a lower-bound binary
    search of each candidate over prev's sorted CSR row, ``steps`` halvings
    (sized from the caller's max-degree bound; an understated bound can
    only give false negatives, exactly as in the reference).

    prev: (n,) walker state; u: (n, D) candidate ids; returns (n, D) bool.
    """
    e = ids_sorted.shape[0]
    prow = torch.clamp(prev, min=0).long()
    hi_row = indptr[prow + 1][:, None]
    lo = indptr[prow][:, None].expand(u.shape).contiguous()
    hi = hi_row.expand(u.shape).contiguous()
    for _ in range(steps):
        open_ = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = ids_sorted[torch.clamp(mid, 0, e - 1)] < u
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    found = (lo < hi_row) & (ids_sorted[torch.clamp(lo, 0, e - 1)] == u)
    return found & mask & (prev >= 0)[:, None] & (u >= 0)


def _window_bias_fn(graph: CSRGraph, program: tp.TransitionProgram, v, prev, depth,
                    max_degree: int):
    """Close the program's window hook over the walker state.

    The returned ``bias_of(rows, u, w, mask)`` builds the EdgeCtx of
    walkers ``rows`` over a gathered window — candidate ids and weights,
    degrees by row lookup, prev-membership by binary search — and runs
    ``WindowBias.fn`` on it.
    """
    wb = program.bias
    deg_v = _degree(graph, v)
    bs_steps = min(32, max(1, max(max_degree, 1).bit_length()))

    def bias_of(rows, u, w, mask):
        vr, pr = v[rows], prev[rows]
        if wb.needs_deg_u:
            deg_u = torch.where(mask, _degree(graph, u), 0)
        else:  # declared unused: reads as zeros
            deg_u = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        ipn = None
        if wb.needs_prev_neighbors:
            ipn = _is_prev_neighbor_window(graph.indptr, graph.indices, pr, u, mask,
                                           steps=bs_steps)
        ctx = EdgeCtx(v=vr, u=u, weight=w, deg_v=deg_v[rows], deg_u=deg_u, prev=pr,
                      is_prev_neighbor=ipn, depth=depth)
        return wb.fn(ctx)

    return bias_of


def walk_window_transition(key, graph: CSRGraph, v, prev, depth, spec: SamplingSpec,
                           program: tp.TransitionProgram, *, buckets: tuple,
                           use_chunked: bool, max_degree: int, home=None) -> torch.Tensor:
    """SELECT + epilogue of one window-bias step (node2vec-class specs)."""
    bias_of = _window_bias_fn(graph, program, v, prev, depth, max_degree)
    u = bk.walk_step_bucketed_window(
        fold_in(key, 1), graph.indptr, graph.indices, graph.weights, v, bias_of,
        buckets=buckets, use_chunked=use_chunked,
    )
    return _select_epilogue(key, graph, program, spec, v, prev, depth, u, home)


def walk_gather_transition(key, graph: CSRGraph, v, prev, depth, spec: SamplingSpec,
                           program: tp.TransitionProgram, *, max_degree: int,
                           home=None) -> torch.Tensor:
    """SELECT + epilogue of one dense-gather step, for opaque programs.

    The ``(W, max_degree)`` context and the ITS draw run in blocks of
    :data:`GATHER_BLOCK` walkers, each slicing one full-batch uniform
    ``uniform(fold_in(key, 1), (W, 1, 1))``, so no walker's pick changes.
    An opaque epilogue (``spec.update``) sees the whole batch's dense
    context, as the reference's hook does, so that step runs as one block.
    """
    w = v.shape[0]
    if w == 0:
        return v.clone()
    opaque_update = isinstance(program.epilogue, tp.OpaqueEpilogue)
    block = w if opaque_update else GATHER_BLOCK
    r = uniform(fold_in(key, 1), (w, 1, 1), device=v.device)
    us = []
    for s in range(0, w, block):
        ctx, mask = _edge_ctx(graph, v[s:s + block], prev[s:s + block], depth, max_degree,
                              spec.needs_prev_neighbors)
        biases = torch.where(mask, spec.edge_bias(ctx), 0.0)
        idx = bk.select_with_replacement(None, biases, mask, 1, rand=r[s:s + block])
        u = torch.gather(ctx.u, 1, idx.long())[:, 0]
        alive = (ctx.v >= 0) & mask.any(dim=-1)
        us.append(torch.where(alive, u, -1))
    u = torch.cat(us)
    if opaque_update:
        nxt = tp.apply_epilogue(fold_in(key, 2), program, spec, ctx, u, home)
        return torch.where(u >= 0, nxt, -1)
    return _select_epilogue(key, graph, program, spec, v, prev, depth, u, home)


def flat_method_plan(
    graph: CSRGraph,
    program: tp.TransitionProgram,
    max_degree: int,
) -> tuple[tuple, mt.MethodTables]:
    """Host-side adaptive selection plan for a flat-bias program.

    Returns ``(methods, tables)``: the cost-model pick per degree cohort
    plus the prebuilt tables it needs (cached per (graph, bias fn)).  A
    forced ``method="its"`` gives the all-ITS plan and no tables; window
    and opaque programs get the empty plan.
    """
    if program.mode != "flat":
        return (), mt.EMPTY_TABLES
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
    words); step ``it`` uses ``fold_in(key, it)``: selection under
    ``fold_in(·, 1)``, the epilogue under ``fold_in(·, 2)``, as the
    reference.  ``max_degree`` bounds the degrees: the flat plan tolerates
    an understated bound (rows truncate); the window plan takes it as the
    true max degree (an understated one truncates rows too); the opaque
    path gathers ``max_degree`` neighbors.  Seeds may be ``-1``: those
    instances are dead on arrival and emit all--1 rows.

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
    mode = program.mode
    if mode == "flat":
        methods, tables = flat_method_plan(graph, program, max_degree)
        flat_bias = program.bias.fn(graph)
        buckets, use_chunked = bk.walk_bucket_plan(max_degree)
    elif mode == "window":
        # the window path treats max_degree as the true max row degree
        buckets, use_chunked = bk.walk_bucket_plan_window(max_degree)
    home = seeds if program.carries_home else None

    cur, prev = seeds, torch.full_like(seeds, -1)
    path = [seeds]
    for it in range(depth):
        kstep = fold_in(key, it)
        if mode == "flat":
            u = bk.walk_step_adaptive(
                fold_in(kstep, 1), graph.indptr, graph.indices, flat_bias, cur,
                buckets=buckets, use_chunked=use_chunked, methods=methods, tables=tables,
            )
            nxt = _select_epilogue(kstep, graph, program, spec, cur, prev, it, u, home)
        elif mode == "window":
            nxt = walk_window_transition(
                kstep, graph, cur, prev, it, spec, program, buckets=buckets,
                use_chunked=use_chunked, max_degree=max_degree, home=home,
            )
        else:
            nxt = walk_gather_transition(kstep, graph, cur, prev, it, spec, program,
                                         max_degree=max_degree, home=home)
        cur, prev = nxt, cur
        path.append(cur)
    walks = torch.stack(path, dim=1)
    lengths = (walks >= 0).sum(dim=-1, dtype=torch.int32)
    return WalkResult(walks, lengths, torch.clamp(lengths - 1, min=0).sum())
