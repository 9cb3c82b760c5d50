"""C-SAW sampling engines (paper Fig. 2(b) MAIN loop): random walks and
traversal sampling.

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
``random_walk_segments`` runs R requests of W walkers as one batch, each
row under its own key (``RowKeys``), one launch a step per method for all
rows.  The three transitions (:func:`walk_flat_transition`,
:func:`walk_window_transition`, :func:`walk_gather_transition`) also serve
the out-of-memory drain (``core.oom``) over a partition's local CSR.

``traversal_sample`` runs the frontier-pool algorithms (neighbor, forest
fire, snowball, layer, MDRW): each step selects a frontier from every
instance's pool and neighbors from its dense context, K of P without
replacement through the ``its_select`` kernel, then updates the pools.

CUDA kernels run on the card, their plain versions on the CPU, with the
reference's counted RNG, so walks and samples equal ``repro``'s bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import backend as bk
from repro_torch.core import methods as mt
from repro_torch.core import select as sel
from repro_torch.core import transition as tp
from repro_torch.core.api import EdgeCtx, SamplingSpec, VertexCtx
from repro_torch.core.rng import RowKeys, fold_in, key_from_array, uniform
from repro_torch.graph.csr import CSRGraph, neighbors_padded, resolve_device

#: walkers per block of the opaque path's dense context: (block, max_degree)
#: tensors, not (W, max_degree) ones, at any W
GATHER_BLOCK = 1 << 18


class WalkResult(NamedTuple):
    walks: torch.Tensor  # (I, depth+1) int32, -1 after termination ((R, W, depth+1) by rows)
    lengths: torch.Tensor  # (I,) realized lengths (# vertices)
    sampled_edges: torch.Tensor  # () total sampled edges (for SEPS; (R,) by rows)
    #: engine counters where the engine keeps them (the sharded walk's
    #: exchange and hub statistics), else None
    stats: Optional[dict] = None


def _degree(graph: CSRGraph, v: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(v, min=0).long()
    return torch.where(v >= 0, graph.indptr[safe + 1] - graph.indptr[safe], 0)


def _edge_ctx(graph: CSRGraph, v, prev, depth, max_degree, needs_prev_neighbors, *,
              partition=None):
    """The dense EDGEBIAS context of a batch of vertices ``v`` of any shape
    (walkers ``(W,)``, traversal frontiers ``(I, fs)``): ``v.shape +
    (max_degree,)`` neighbor ids, weights and degrees, and — when asked —
    membership of each candidate in N(prev) by an O(D²) compare.  Built over
    the flattened batch and reshaped back.  Returns ``(ctx, mask)``.

    With ``partition`` (a ``graph.partition.DevicePartition``), ``graph`` is
    its local CSR with the phantom row: rows are looked up at localized ids,
    the context holds global ids (``partition.indices_global``), and
    neighbors outside the partition read degree 0 off the phantom row, as
    the reference's out-of-memory drain reads them.
    """
    shape = tuple(v.shape) + (max_degree,)
    vf, pf = v.reshape(-1), prev.reshape(-1)
    local = partition is not None
    if local:
        vq, pq = partition.localize(vf), partition.localize(pf)
    else:
        vq, pq = torch.clamp(vf, min=0), torch.clamp(pf, min=0)
    nbrs, wts, mask = neighbors_padded(graph, vq, max_degree)
    nbrs_row = nbrs  # row-lookup ids (local in partition mode)
    if local:
        nbrs = _global_ids(graph, partition, vq, mask, max_degree, -1)
    nbrs = torch.where((vf >= 0)[:, None] & mask, nbrs, -1)
    mask = nbrs >= 0
    ipn = None
    if needs_prev_neighbors:
        if local:
            _, _, pmask = neighbors_padded(graph, pq, max_degree)
            pnbrs = _global_ids(graph, partition, pq, pmask, max_degree, -2)
        else:
            pnbrs, _, pmask = neighbors_padded(graph, pq, max_degree)
        pnbrs = torch.where((pf >= 0)[:, None] & pmask & (pnbrs >= 0), pnbrs, -2)
        ipn = ((nbrs[:, :, None] == pnbrs[:, None, :]).any(dim=-1) & mask).reshape(shape)
    deg_u = _degree(graph, nbrs_row if local else nbrs)
    ctx = EdgeCtx(
        v=v, u=nbrs.reshape(shape), weight=wts.reshape(shape),
        deg_v=_degree(graph, vq if local else vf).reshape(v.shape),
        deg_u=torch.where(mask, deg_u, 0).reshape(shape), prev=prev,
        is_prev_neighbor=ipn, depth=depth,
    )
    return ctx, mask.reshape(shape)


def _global_ids(graph, partition, rows, mask, max_degree, fill):
    """The global ids of the padded neighbor lists of local ``rows``."""
    eidx = graph.indptr[rows.long()].long()[:, None] + torch.arange(max_degree, device=rows.device)
    return torch.where(mask, partition.indices_global[torch.where(mask, eidx, 0)], fill)


def _select_epilogue(key, graph, program, spec, v, prev, depth, u, home, row_of=None):
    """The post-select step of every mode: the minimal D = 1 EdgeCtx of the
    selected edge (unit ``weight`` placeholder, as the reference's fast
    paths) and the lowered epilogue under ``fold_in(key, 2)``.  ``row_of``
    maps global ids to ``graph``'s rows (a partition's ``localize``)."""
    if isinstance(program.epilogue, tp.IdentityEpilogue):
        return u  # the selected neighbor, -1 for dead walkers
    vq = v if row_of is None else row_of(v)
    uq = u if row_of is None else row_of(u)
    ctx = EdgeCtx(
        v=v, u=u[:, None], weight=torch.ones(u.shape + (1,), device=u.device),
        deg_v=_degree(graph, vq), deg_u=_degree(graph, uq)[:, None], prev=prev,
        is_prev_neighbor=None, depth=depth,
    )
    nxt = tp.apply_epilogue(fold_in(key, 2), program, spec, ctx, u, home)
    return torch.where(u >= 0, nxt, -1)


def walk_flat_transition(key, graph: CSRGraph, indices_out, flat_bias, v, prev, depth,
                         spec: SamplingSpec, program: tp.TransitionProgram, *, buckets: tuple,
                         use_chunked: bool, methods: tuple, tables, row_of=None,
                         home=None) -> torch.Tensor:
    """SELECT + epilogue of one flat-bias step, shared by the in-memory
    walks and the out-of-memory drain (``core.oom``).

    ``core.backend.walk_step_adaptive`` under ``fold_in(key, 1)`` over
    ``graph``'s rows and ``flat_bias``, emitting ``indices_out`` (the
    graph's ids in memory; a partition's ``indices_global`` in the drain,
    with ``row_of`` its ``localize``: the kernels read the local ``indptr``
    at localized vertices), then the epilogue.
    """
    vq = v if row_of is None else row_of(v)
    u = bk.walk_step_adaptive(
        fold_in(key, 1), graph.indptr, indices_out, flat_bias, vq, buckets=buckets,
        use_chunked=use_chunked, methods=methods, tables=tables,
    )
    return _select_epilogue(key, graph, program, spec, v, prev, depth, u, home, row_of)


def _is_prev_neighbor_window(indptr, ids_sorted, prow, prev, u, mask, *, steps: int):
    """Membership of window candidates in N(prev): a lower-bound binary
    search of each candidate over prev's sorted CSR row, ``steps`` halvings
    (sized from the caller's max-degree bound; an understated bound can
    only give false negatives, exactly as in the reference).

    prow: (n,) row-lookup ids of prev (localized in partition mode); prev:
    (n,) walker state; u: (n, D) candidate global ids; returns (n, D) bool.
    """
    e = ids_sorted.shape[0]
    prow = prow.long()
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
                    max_degree: int, row_of=None, ids_sorted=None):
    """Close the program's window hook over the walker state.

    The returned ``bias_of(rows, u, w, mask, eidx=None)`` builds the EdgeCtx of
    walkers ``rows`` over a gathered window — candidate ids and weights,
    degrees by row lookup, prev-membership by binary search over
    ``ids_sorted`` (the ids the walk emits, ``graph.indices`` by default) —
    and runs ``WindowBias.fn`` on it.  ``row_of`` maps global ids to
    ``graph``'s rows (a partition's ``localize``: non-resident neighbors
    read degree 0 off the phantom row).
    """
    wb = program.bias
    vq = v if row_of is None else row_of(v)
    pq = torch.clamp(prev, min=0) if row_of is None else row_of(prev)
    ids = graph.indices if ids_sorted is None else ids_sorted
    deg_v = _degree(graph, vq)
    bs_steps = min(32, max(1, max(max_degree, 1).bit_length()))

    def bias_of(rows, u, w, mask, eidx=None):
        vr, pr = v[rows], prev[rows]
        if wb.needs_deg_u:
            uq = u if row_of is None else row_of(u)
            deg_u = torch.where(mask, _degree(graph, uq), 0)
        else:  # declared unused: reads as zeros
            deg_u = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        ipn = None
        if wb.needs_prev_neighbors:
            ipn = _is_prev_neighbor_window(graph.indptr, ids, pq[rows], pr, u, mask,
                                           steps=bs_steps)
        ctx = EdgeCtx(v=vr, u=u, weight=w, deg_v=deg_v[rows], deg_u=deg_u, prev=pr,
                      is_prev_neighbor=ipn, depth=depth)
        return wb.fn(ctx)

    return bias_of


def walk_window_transition(key, graph: CSRGraph, indices_out, v, prev, depth,
                           spec: SamplingSpec, program: tp.TransitionProgram, *,
                           buckets: tuple, use_chunked: bool, max_degree: int, row_of=None,
                           home=None) -> torch.Tensor:
    """SELECT + epilogue of one window-bias step (node2vec-class specs),
    shared by the in-memory walks and the out-of-memory drain
    (``indices_out`` and ``row_of`` as in :func:`walk_flat_transition`)."""
    vq = v if row_of is None else row_of(v)
    bias_of = _window_bias_fn(graph, program, v, prev, depth, max_degree, row_of, indices_out)
    u = bk.walk_step_bucketed_window(
        fold_in(key, 1), graph.indptr, indices_out, graph.weights, vq, bias_of,
        buckets=buckets, use_chunked=use_chunked,
    )
    return _select_epilogue(key, graph, program, spec, v, prev, depth, u, home, row_of)


def walk_gather_transition(key, graph: CSRGraph, v, prev, depth, spec: SamplingSpec,
                           program: tp.TransitionProgram, *, max_degree: int,
                           home=None, partition=None) -> torch.Tensor:
    """SELECT + epilogue of one dense-gather step, for opaque programs.

    The ``(W, max_degree)`` context and the ITS draw run in blocks of
    :data:`GATHER_BLOCK` walkers, each slicing one full-batch uniform
    ``uniform(fold_in(key, 1), (W, 1, 1))``, so no walker's pick changes.
    An opaque epilogue (``spec.update``) sees the whole batch's dense
    context, as the reference's hook does, so that step runs as one block.
    ``partition`` builds the context over a partition's local CSR
    (:func:`_edge_ctx`).
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
                              spec.needs_prev_neighbors, partition=partition)
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
    walks = _walk(graph, seeds, key_from_array(key), depth=depth, spec=spec,
                  max_degree=max_degree)
    lengths = (walks >= 0).sum(dim=-1, dtype=torch.int32)
    return WalkResult(walks, lengths, torch.clamp(lengths - 1, min=0).sum())


def _walk(graph: CSRGraph, seeds: torch.Tensor, key, *, depth: int, spec: SamplingSpec,
          max_degree: int) -> torch.Tensor:
    """The walk loop of :func:`random_walk` and :func:`random_walk_segments`
    over flat seeds ``(N,)`` on the graph's device, under one key or
    ``RowKeys`` (one a row of the flattened batch).  Returns the walks
    ``(N, depth + 1)``."""
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
            nxt = walk_flat_transition(
                kstep, graph, graph.indices, flat_bias, cur, prev, it, spec, program,
                buckets=buckets, use_chunked=use_chunked, methods=methods, tables=tables,
                home=home,
            )
        elif mode == "window":
            nxt = walk_window_transition(
                kstep, graph, graph.indices, cur, prev, it, spec, program, buckets=buckets,
                use_chunked=use_chunked, max_degree=max_degree, home=home,
            )
        else:
            nxt = walk_gather_transition(kstep, graph, cur, prev, it, spec, program,
                                         max_degree=max_degree, home=home)
        cur, prev = nxt, cur
        path.append(cur)
    return torch.stack(path, dim=1)


def random_walk_segments(
    graph: CSRGraph,
    seeds,
    keys,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
    device="cuda",
) -> WalkResult:
    """R independent requests in one batch: the multi-request segment path
    of ``repro.core.engine.random_walk_segments``.

    ``seeds`` is ``(R, W)``, one row a request, padded with -1; ``keys`` is
    ``(R, 2)``, a key a row (``jax.random.key_data`` words).  Row ``r`` of
    the result equals ``random_walk(graph, seeds[r], keys[r], ...)`` bit for
    bit: walker ``i`` of row ``r`` draws under row ``r``'s keys at counter
    ``i``, as ``jax.vmap`` over the rows draws.  The rows share one
    selection plan and one set of tables, and each step makes one launch
    per method for all R rows: the step kernels read each row's keys from a
    device table that one ``derive_keys`` launch fills (``RowKeys``), and
    the draws made in tensor code hash every ``(row key, counter)`` pair in
    one pass.

    Returns a ``WalkResult`` with a leading row axis: ``walks`` ``(R, W,
    depth + 1)``, ``lengths`` ``(R, W)``, ``sampled_edges`` ``(R,)``.  Runs
    on ``device`` — ``cuda`` unless the caller passes ``"cpu"``.

    >>> import numpy as np
    >>> from repro_torch.core import algorithms as alg
    >>> from repro_torch.core.rng import PRNGKey, fold_in
    >>> from repro_torch.graph import csr_from_edges
    >>> g = csr_from_edges(4, [0, 1, 2, 3], [1, 2, 3, 0], symmetrize=True, device="cpu")
    >>> seeds = [[0, 1, -1, -1], [2, 3, 1, 0]]
    >>> keys = np.stack([fold_in(PRNGKey(7), r) for r in range(2)])
    >>> fused = random_walk_segments(g, seeds, keys, depth=3, spec=alg.deepwalk(),
    ...                              max_degree=2, device="cpu")
    >>> solo = random_walk(g, seeds[1], keys[1], depth=3, spec=alg.deepwalk(),
    ...                    max_degree=2, device="cpu")
    >>> bool((fused.walks[1] == solo.walks).all()), tuple(fused.sampled_edges.tolist())
    (True, (6, 12))
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    seeds = torch.as_tensor(seeds).to(device=dev, dtype=torch.int32)
    if seeds.dim() != 2:
        raise ValueError(f"random_walk_segments: seeds must be (R, W), got {tuple(seeds.shape)}")
    r, w = seeds.shape
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    words = np.asarray(keys, dtype=np.uint32).reshape(r, 2)
    base = torch.from_numpy(words.view(np.int32).copy()).to(dev)
    walks = _walk(graph, seeds.reshape(-1), RowKeys(base, w), depth=depth, spec=spec,
                  max_degree=max_degree).reshape(r, w, depth + 1)
    lengths = (walks >= 0).sum(dim=-1, dtype=torch.int32)
    return WalkResult(walks, lengths, torch.clamp(lengths - 1, min=0).sum(dim=-1))


# ---------------------------------------------------------------------------
# Traversal sampling (paper Fig. 2(b) MAIN over frontier pools)
# ---------------------------------------------------------------------------

#: elements per block of traversal's dense context: each block of instances
#: gathers at most this many (row, candidate) entries at once
TRAVERSAL_ELEMS = 1 << 27


class SampleResult(NamedTuple):
    edges_src: torch.Tensor  # (I, cap) int32 sampled edge sources (-1 pad)
    edges_dst: torch.Tensor  # (I, cap) int32 sampled edge destinations
    num_edges: torch.Tensor  # (I,) int32 per-instance sampled edge count
    frontier_pool: torch.Tensor  # (I, C) int32 final pool
    iters: torch.Tensor  # () int32 total selection retry rounds (Fig. 11)
    searches: torch.Tensor  # () int32 total CTPS searches (Fig. 12)


def _in_visited(visited: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``visited[i, u]`` for ``u`` of shape ``(I, ...)``; ids at or past the
    bitmap's width read as visited (the reference's out-of-bounds gather
    fills with True), -1 as not visited."""
    width = visited.shape[1]
    flat = u.reshape(u.shape[0], -1)
    got = torch.gather(visited, 1, torch.clamp(flat, 0, width - 1).long())
    got = torch.where(flat >= width, True, got) & (flat >= 0)
    return got.reshape(u.shape)


def _mark_visited(visited: torch.Tensor, v: torch.Tensor) -> None:
    """Set ``visited[i, v]`` in place for the ids ``0 <= v < width`` of each
    instance's row ``v[i]`` (the reference's one-hot drops the others)."""
    ok = (v >= 0) & (v < visited.shape[1])
    rows = torch.arange(v.shape[0], device=v.device)[:, None].expand(v.shape)
    visited[rows[ok].long(), v[ok].long()] = True


def _insert_into_pool(pool: torch.Tensor, new_v: torch.Tensor) -> torch.Tensor:
    """Insert new vertices into -1 slots, left-compacting both sides.

    One cumsum compaction over the concatenated ``(pool, new)`` row, as the
    reference: surviving pool entries keep their order in the first slots,
    new entries follow, overflow past the capacity is dropped.  A scatter to
    each entry's slot replaces the reference's ``(I, C + n, C)`` one-hot.
    """
    cap = pool.shape[-1]
    merged = torch.cat([pool, new_v], dim=-1)
    valid = merged >= 0
    pos = torch.cumsum(valid.to(torch.int32), dim=-1) - 1
    slot = torch.where(valid & (pos < cap), pos, cap).long()
    out = torch.full((pool.shape[0], cap + 1), -1, dtype=pool.dtype, device=pool.device)
    out.scatter_(1, slot, torch.where(slot < cap, merged, -1))
    return out[:, :cap].contiguous()


def _select_frontier(key, graph: CSRGraph, pool, depth, spec: SamplingSpec, method: str):
    """SELECT the ``(I, fs)`` frontier from each pool by VERTEXBIAS; returns
    ``(frontier, selection)``, -1 where fewer candidates were selectable."""
    pmask = pool >= 0
    vctx = VertexCtx(v=pool, deg=torch.where(pmask, _degree(graph, pool), 0), depth=depth)
    vbias = torch.where(pmask, spec.vertex_bias(vctx), 0.0)
    res = bk.select_without_replacement(key, vbias, pmask, spec.frontier_size, method=method)
    picked = torch.gather(pool, 1, torch.clamp(res.indices, 0, pool.shape[1] - 1).long())
    return torch.where(res.valid, picked, -1), res


def _neighbor_context(graph: CSRGraph, frontier, visited, depth, spec: SamplingSpec,
                      max_degree: int):
    """GATHER + EDGEBIAS for a block of frontiers ``(b, fs)``: the dense
    context, the masked biases with visited candidates zeroed (``visited``
    the block's rows of the map, or None) and the candidate mask."""
    ctx, emask = _edge_ctx(graph, frontier, torch.full_like(frontier, -1), depth, max_degree,
                           spec.needs_prev_neighbors)
    ebias = torch.where(emask, spec.edge_bias(ctx), 0.0)
    if visited is not None:
        seen = _in_visited(visited, ctx.u)
        ebias = torch.where(seen, 0.0, ebias)
        emask = emask & ~seen
    return ctx, ebias, emask


def _sample_neighbors(key, graph: CSRGraph, frontier, visited, depth, spec: SamplingSpec, *,
                      max_degree: int, method: str):
    """GATHER + EDGEBIAS + SELECT-neighbors of one step, in blocks of
    instances (at most :data:`TRAVERSAL_ELEMS` dense entries a block).

    Each block builds its instances' dense context, zeroes visited
    candidates and selects over its rows; the selection's counted draws are
    the full batch's at the block's rows (``offset``), so no pick depends
    on the blocking.  Returns ``(src, dst, iters, searches)``: per-vertex
    specs give ``(I, fs, ns)`` picks, pooled ones ``(I, ns)``.
    """
    n_inst, fs = frontier.shape
    ns = spec.neighbor_size
    width = fs * max(max_degree, 1)
    block = max(1, TRAVERSAL_ELEMS // width)
    srcs, dsts, iters, searches = [], [], 0, 0
    for s in range(0, n_inst, block):
        fr = frontier[s:s + block]
        b = fr.shape[0]
        ctx, ebias, emask = _neighbor_context(
            graph, fr, None if visited is None else visited[s:s + b], depth, spec, max_degree)
        if spec.per_vertex:
            # an independent NeighborPool per frontier vertex (neighbor sampling)
            res = bk.select_without_replacement(key, ebias, emask, ns, method=method,
                                                offset=s * fs)
            gi = torch.clamp(res.indices, 0, max_degree - 1).long()
            srcs.append(fr[..., None].expand(b, fs, ns))
            dsts.append(torch.where(res.valid, torch.gather(ctx.u, -1, gi), -1))
        else:
            # one pooled NeighborPool over all frontier vertices (layer, MDRW)
            res = bk.select_without_replacement(key, ebias.reshape(b, -1), emask.reshape(b, -1),
                                                ns, method=method, offset=s)
            gi = torch.clamp(res.indices, 0, width - 1).long()
            flat_v = fr[..., None].expand(ctx.u.shape).reshape(b, -1)
            srcs.append(torch.where(res.valid, torch.gather(flat_v, -1, gi), -1))
            dsts.append(torch.where(res.valid, torch.gather(ctx.u.reshape(b, -1), -1, gi), -1))
        iters = iters + res.iters.sum(dtype=torch.int64)
        searches = searches + res.searches.sum(dtype=torch.int64)
        del ctx, emask, ebias
    return torch.cat(srcs), torch.cat(dsts), iters, searches


def traversal_sample(
    graph: CSRGraph,
    seed_pools,
    key,
    *,
    depth: int,
    spec: SamplingSpec,
    max_degree: int,
    pool_capacity: int,
    method: str = "its_brs",
    max_vertices: int = 0,
    device="cuda",
) -> SampleResult:
    """Paper Fig. 2(b) MAIN over frontier pools: each step SELECTs a
    frontier from every instance's pool, GATHERs its neighbors, SELECTs
    neighbors and UPDATEs the pool, as ``repro.core.engine.traversal_sample``.

    ``seed_pools`` is ``(I, S)``, -1 padded; ``max_vertices > 0`` (with
    ``spec.track_visited``) keeps a visited map of that many vertices, so an
    instance never samples a vertex twice.  Step ``it`` uses ``kit =
    fold_in(key, it)``: the frontier selection under ``fold_in(kit, 0)``,
    the neighbor selection under ``fold_in(kit, 1)``, forest fire's burn
    under ``fold_in(kit, 7)`` and the UPDATE epilogue under
    ``fold_in(kit, 2)``, as the reference, so the samples and the Fig.
    11/12 counters equal the reference's bit for bit.  ``its_brs``
    selections run the ``its_select`` kernel on the card (any K and P);
    the other methods run in plain PyTorch.  The dense neighbor context
    runs in blocks of instances (:data:`TRAVERSAL_ELEMS`).

    Runs on ``device`` — ``cuda`` unless the caller passes ``"cpu"``.

    Example — 2-hop neighbor sampling from two 1-seed instances on a
    4-cycle, on the CPU (every sampled edge is a graph edge):

    >>> from repro_torch.core import algorithms as alg
    >>> from repro_torch.core.rng import PRNGKey
    >>> from repro_torch.graph import csr_from_edges
    >>> g = csr_from_edges(4, [0, 1, 2, 3], [1, 2, 3, 0], symmetrize=True, device="cpu")
    >>> res = traversal_sample(g, [[0], [2]], PRNGKey(0), depth=2,
    ...                        spec=alg.unbiased_neighbor_sampling(), max_degree=2,
    ...                        pool_capacity=8, max_vertices=4, device="cpu")
    >>> tuple(res.edges_src.shape), bool((res.num_edges >= 1).all())
    ((2, 32), True)
    """
    dev = resolve_device(device)
    graph = graph.to(dev)
    seed_pools = torch.as_tensor(seed_pools).to(device=dev, dtype=torch.int32)
    key = key_from_array(key)
    program = tp.lower(spec)
    n_inst = seed_pools.shape[0]
    fs, ns = spec.frontier_size, spec.neighbor_size
    per_iter = fs * ns if spec.per_vertex else ns
    cap = depth * per_iter
    track = spec.track_visited and max_vertices > 0

    pool = torch.full((n_inst, pool_capacity), -1, dtype=torch.int32, device=dev)
    pool[:, :seed_pools.shape[1]] = seed_pools[:, :pool_capacity]
    visited = None
    if track:
        visited = torch.zeros((n_inst, max_vertices), dtype=torch.bool, device=dev)
        _mark_visited(visited, seed_pools)
    esrc = torch.full((n_inst, cap), -1, dtype=torch.int32, device=dev)
    edst = torch.full_like(esrc, -1)
    ecnt = torch.zeros(n_inst, dtype=torch.int32, device=dev)
    tot_iters = torch.zeros((), dtype=torch.int64, device=dev)
    tot_searches = torch.zeros((), dtype=torch.int64, device=dev)

    for it in range(depth):
        kit = fold_in(key, it)
        # SELECT frontier from pool (line 4)
        frontier, fres = _select_frontier(fold_in(kit, 0), graph, pool, it, spec, method)
        tot_iters += fres.iters.sum(dtype=torch.int64)
        tot_searches += fres.searches.sum(dtype=torch.int64)

        # GATHER + EDGEBIAS + SELECT neighbors (lines 5-6)
        src, dst, n_iters, n_searches = _sample_neighbors(
            fold_in(kit, 1), graph, frontier, visited, it, spec, max_degree=max_degree,
            method=method)
        tot_iters += n_iters
        tot_searches += n_searches
        if spec.per_vertex:
            if spec.burn_prob is not None:
                # forest fire: keep a geometric(p_f) prefix of the ns draws
                g = uniform(fold_in(kit, 7), dst.shape, device=dev)
                keep = torch.cumprod((g < tp.f32(spec.burn_prob)).to(torch.int32), dim=-1) > 0
                keep = keep | (torch.arange(ns, device=dev) == 0)  # burn at least one
                dst = torch.where(keep, dst, -1)
            src, dst = src.reshape(n_inst, -1), dst.reshape(n_inst, -1)
            if spec.track_visited:
                # two frontier vertices may draw the same neighbor in one
                # round (separate NeighborPools): keep the first
                dup = (dst >= 0) & ~sel._dedup_priority(dst, dst >= 0)
                dst = torch.where(dup, -1, dst)
        valid = dst >= 0

        # record sampled edges (line 8)
        esrc[:, it * per_iter:(it + 1) * per_iter] = src
        edst[:, it * per_iter:(it + 1) * per_iter] = dst
        ecnt += valid.sum(dim=-1, dtype=torch.int32)

        # UPDATE pool (line 7), through the lowered epilogue the walks run
        ectx = EdgeCtx(
            v=src, u=dst, weight=torch.ones(dst.shape, dtype=torch.float32, device=dev),
            deg_v=torch.where(src >= 0, _degree(graph, src), 0),
            deg_u=torch.where(dst >= 0, _degree(graph, dst), 0),
            prev=torch.full((n_inst,), -1, dtype=torch.int32, device=dev),
            is_prev_neighbor=None, depth=it,
        )
        new_v = tp.apply_epilogue(fold_in(kit, 2), program, spec, ectx, dst)
        new_v = torch.where(valid, new_v, -1)
        if track:
            _mark_visited(visited, new_v)
        if spec.replace_selected:
            # MDRW: drop the selected frontier vertices, insert the new ones
            sel_ids = torch.where(frontier >= 0, frontier, -2)
            drop = (pool[:, :, None] == sel_ids[:, None, :]).any(dim=-1)
            pool = _insert_into_pool(torch.where(drop, -1, pool), new_v)
        elif spec.per_vertex:
            # BFS-style: the next pool is exactly the newly sampled layer
            pool = _insert_into_pool(torch.full_like(pool, -1), new_v)
        else:
            pool = _insert_into_pool(pool, new_v)
    return SampleResult(esrc, edst, ecnt, pool, tot_iters.to(torch.int32),
                        tot_searches.to(torch.int32))
