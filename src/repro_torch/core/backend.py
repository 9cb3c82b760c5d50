"""Degree-bucketed walk scheduling, and the ITS draw of the dense path.

Per step, walkers are split by degree into cohorts — ``(0, 128]`` and
``(128, 512]`` — each with a per-cohort row cap, and degrees above the top
bucket take a tail (the workload-aware scheduling of the paper, as
``repro.core.backend`` runs it).

- :func:`walk_step_adaptive` — flat biases, a selection method per cohort
  (ITS, alias or rejection), one kernel launch per method and step; an
  all-ITS plan is ``methods=("its", …)``.
- :func:`walk_step_bucketed_window` — window biases (node2vec): the hook is
  evaluated on each cohort's compact row windows, the pick runs the
  ``walk_step_window`` kernel, and the tail is the chunked window scan.
- :func:`select_with_replacement` — the opaque path's ITS draw over dense
  candidate rows, through the ``its_select`` kernel;
- :func:`select_without_replacement` — traversal sampling's K-of-P
  selection: ``its_brs`` through the ``its_select`` kernel with the
  counted retry budget, the other methods in plain PyTorch.

The device of the tensors decides what runs: on the card every cohort
launches its CUDA kernel, on the CPU the kernels' plain versions run.

Every key here may also be ``rng.RowKeys`` (``random_walk_segments``: R
rows of W walkers in one batch): the step kernels then read each row's
keys from a device table, and the draws made in tensor code (the window
uniform, the tails' uniforms) hash each walker's counter within its row
under its row's key, in one pass over the batch.  Or ``rng.EntryKeys``
(the sharded drain: queue entries at their own depths): each entry draws
under its depth's key at its instance, in the kernels and in tensor code
alike.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import select as sel
from repro_torch.core.rng import fold_in, uniform, uniform_at
from repro_torch.kernels import ref
from repro_torch.kernels.alias_select import alias_step
from repro_torch.kernels.its_select import its_select
from repro_torch.kernels.walk_step import reject_step, walk_step, walk_step_window

#: candidate pools are padded to multiples of the reference's lane width
LANES = 128

#: default degree-bucket ladder for the walk fast path:
#: deg ∈ (0, 128] → small cohort, (128, 512] → medium cohort, > 512 → tail
WALK_BUCKETS = (128, 512)

#: chunk width of the two-pass huge-degree ITS scan
CHUNK = 512


def pad_lanes(biases: torch.Tensor) -> torch.Tensor:
    """Pad the candidate (last) dim to a lane multiple with zero bias."""
    pad = (-biases.shape[-1]) % LANES
    return torch.nn.functional.pad(biases, (0, pad)) if pad else biases


_masked = sel._masked


def select_with_replacement(
    key,
    biases: torch.Tensor,
    mask: torch.Tensor | None,
    k: int,
    *,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """ITS draw *with* replacement over ``(W, P)`` candidate rows.

    ``k == 1`` runs the ``its_select`` kernel with a one-round budget (a
    single draw cannot collide, so selection without replacement computes
    the with-replacement draw): the uniform is ``uniform(key, (W, 1, 1))``,
    the bits of the reference's ``(W, 1)`` draw, and the rows are padded to
    a lane multiple with zeros as the reference pads them.  ``rand``
    overrides that draw with ``(W, 1, 1)`` uniforms (the engine slices
    one full-batch draw into blocks).  All-zero rows give ``P - 1`` like
    the reference.  Larger ``k`` runs :func:`select.select_with_replacement`.
    """
    if k != 1:
        return sel.select_with_replacement(key, biases, mask, k)
    p = biases.shape[-1]
    if rand is None:
        rand = uniform(key, (biases.shape[0], 1, 1), device=biases.device)
    idx, _ = its_select(pad_lanes(_masked(biases, mask)).contiguous(), rand.contiguous())
    return torch.where(idx >= 0, idx, p - 1)


def select_without_replacement(
    key,
    biases: torch.Tensor,
    mask: torch.Tensor | None,
    k: int,
    *,
    method: str = "its_brs",
    max_iters: int = 32,
    offset: int = 0,
) -> sel.SelectResult:
    """K-of-P selection without replacement over ``(..., P)`` rows, as
    ``repro.core.backend.select_without_replacement`` runs it on the Pallas
    backend.

    ``its_brs`` runs the ``its_select`` kernel over the rows padded to a
    lane multiple with zeros, with the counted retry budget
    ``retry_randoms(key, batch, max_iters, k)``, so indices, validity and
    the ``(iters, searches)`` counters equal the reference retry loop's.
    ``gumbel``, ``repeated`` and ``updated`` have no kernel: they run
    ``select.select_without_replacement`` in plain PyTorch on the rows'
    device and, on the card, report ``fell_back=True``.  ``offset`` is the
    first row in the batch the key's draws cover (the engine selects in
    blocks of rows).
    """
    if method != "its_brs":
        res = sel.select_without_replacement(key, biases, mask, k, method=method,
                                             max_iters=max_iters, offset=offset)
        return res._replace(fell_back=biases.device.type == "cuda")
    b = _masked(biases, mask)
    batch, p = b.shape[:-1], b.shape[-1]
    n = int(np.prod(batch))
    rands = sel.retry_randoms(key, (n,), max_iters, k, device=b.device, offset=offset)
    idx, stats = its_select(pad_lanes(b.reshape(n, p)).contiguous(), rands)
    return sel.SelectResult(idx.reshape(*batch, k), (idx >= 0).reshape(*batch, k),
                            stats[:, 0].reshape(batch), stats[:, 1].reshape(batch))


def walk_bucket_plan(
    max_degree: int, segs: tuple = WALK_BUCKETS, exact: bool = False
) -> tuple[tuple, bool]:
    """Static per-graph schedule: kernel segment sizes + need for the tail.

    Returns ``(buckets, use_chunked)``: one cohort per bucket segment the
    graph can populate, plus the huge-degree tail for degrees above the last
    segment.  With ``exact=True`` the caller asserts ``max_degree`` is the
    true max row degree, and the top segment shrinks to the smallest
    multiple of the bucket below it that covers it (a graph with max degree
    219 runs its top cohort in 256-wide windows).
    """
    buckets = []
    lo = 0
    for s in segs:
        if max_degree > lo:
            buckets.append(s)
        lo = s
    if not buckets:
        buckets = [segs[0]]
    if exact:
        base = buckets[-2] if len(buckets) > 1 else LANES
        fit = max(-(-max(max_degree, 1) // base) * base, LANES)
        buckets[-1] = min(buckets[-1], fit)
    return tuple(buckets), max_degree > segs[-1]


def walk_bucket_plan_window(max_degree: int, segs: tuple = WALK_BUCKETS) -> tuple[tuple, bool]:
    """Bucket plan for the window-bias path: exact, and ladder-merged.

    Every cohort re-evaluates the hook, so the ladder collapses into the top
    cohort when that is at most twice the bottom one.  Degrees above the
    top segment take the chunked window tail.
    """
    buckets, use_chunked = walk_bucket_plan(max_degree, segs, exact=True)
    if len(buckets) > 1 and buckets[-1] <= 2 * buckets[0]:
        buckets = buckets[-1:]
    return tuple(buckets), use_chunked


def _chunked_tail(key, indptr, indices, safe, deg, seg_hi, nxt, scan):
    """Route walkers with ``deg > seg_hi`` through a two-pass chunked scan
    (only those walkers: the scan runs to their longest row).
    ``scan(huge, vertices, rand)`` returns each one's edge offset, -1 for a
    dead end; its uniforms are ``uniform(key, (W,))``'s at their indices,
    hashed for them alone."""
    huge = torch.nonzero(deg > seg_hi).squeeze(1)
    if huge.numel() == 0:
        return nxt
    rand = uniform_at(key, huge)
    rows = safe[huge]
    off = scan(huge, rows, rand)
    eidx = torch.clamp(indptr[rows].long() + torch.clamp(off, min=0), 0, indices.shape[0] - 1)
    nxt = nxt.clone()
    nxt[huge] = torch.where(off >= 0, indices[eidx], -1)
    return nxt


def walk_step_adaptive(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    flat_bias: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    tables,
) -> torch.Tensor:
    """One flat-bias transition for all walkers, with a method per cohort.

    ``methods`` (from ``core.methods.plan_for_graph``) names the draw of each
    degree cohort — ``"its"``, ``"alias"`` (``tables.prob``/``tables.alias``)
    or ``"rejection"`` (envelope ``tables.row_max``) — one entry per bucket
    plus one for the tail when present.  Each method runs one kernel launch
    for all its cohorts: ``reject_step`` and ``alias_step`` (the tail
    included) and ``walk_step`` find their walkers' cohorts themselves and
    write them into one output.  An ITS tail takes the chunked scan.

    Counted RNG, as the reference: the bucket uniform is ``fold_in(key, 0)``
    (alias cohorts consume the same uniform an ITS cohort would); the ITS
    and alias tails use ``fold_in(key, 1)``; the rejection budget, shared by
    every rejection cohort including the tail, is
    ``rejection_randoms(fold_in(key, 2))``; walker ``i`` draws at counter
    ``i`` of each.  The three step kernels hash their walkers' uniforms
    themselves, and an ITS tail hashes its uniforms for its walkers alone,
    so no W-wide uniform is drawn; the host derives the keys.  Alias and
    rejection tails draw over the whole row; only an ITS tail scans.
    Returns next vertices (W,) int32, -1 for finished walkers and dead ends.
    """
    nxt = torch.full_like(cur, -1)
    ladder = dict(buckets=buckets, use_chunked=use_chunked, methods=methods, out=nxt)
    if "rejection" in methods:
        reject_step(key, indptr, indices, flat_bias, tables.row_max, cur, **ladder)
    if "its" in methods[:len(buckets)]:
        walk_step(key, indptr, indices, flat_bias, cur, **ladder)
    if "alias" in methods:
        alias_step(key, indptr, indices, tables.prob, tables.alias, cur, **ladder)
    if use_chunked and methods[len(buckets)] == "its":
        safe, _, deg = ref.walker_rows(indptr, cur)
        nxt = _chunked_tail(
            fold_in(key, 1), indptr, indices, safe, deg, buckets[-1], nxt,
            lambda huge, rows, rand: sel.walk_transition_chunked(
                None, indptr, flat_bias, rows, chunk=CHUNK, rand=rand),
        )
    return nxt


def window_bias_rows(indices, weights, st, dg, rows, bias_of, seg: int) -> torch.Tensor:
    """The ``(n, seg)`` bias rows of one window cohort: walkers ``rows``
    with row starts ``st`` and capped degrees ``dg`` gather their ids and
    weights, and the hook's bias ``bias_of(rows, u, w, mask, eidx)``
    (``eidx`` the edge positions), clipped at 0, fills columns ``< dg``
    (zeros elsewhere).  Evaluated in blocks of ``select.ROW_BLOCK`` walkers,
    which bounds the hook's temporaries."""
    bias = torch.empty((rows.shape[0], seg), dtype=torch.float32, device=st.device)
    offs = torch.arange(seg, device=st.device)
    for b in range(0, rows.shape[0], sel.ROW_BLOCK):
        blk = slice(b, b + sel.ROW_BLOCK)
        cmask = offs < dg[blk, None]
        eidx = torch.where(cmask, st[blk, None].long() + offs, 0)
        u = torch.where(cmask, indices[eidx], -1)
        wt = torch.where(cmask, weights[eidx], 0.0)
        bias[blk] = torch.where(
            cmask, torch.clamp(bias_of(rows[blk], u, wt, cmask, eidx), min=0.0), 0.0)
    return bias


def walk_step_bucketed_window(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    cur: torch.Tensor,
    bias_of,
    *,
    buckets: tuple,
    use_chunked: bool,
) -> torch.Tensor:
    """One window-bias (dynamic) transition for all walkers, by degree.

    Per bucket, the cohort's members (only those: the reference evaluates
    every walker at every width, which would not fit the card at full size)
    gather their compact ``(n, seg)`` row windows — ids and weights — and
    ``bias_of(rows, u, w, mask, eidx)`` evaluates the hook on them
    (``rows`` index the walkers, ``eidx`` are the window's edge positions;
    :func:`window_bias_rows`); the clipped, masked bias
    rows go to one ``walk_step_window`` launch as they are.  The hook is
    per-edge, so each member's bias equals the reference's.  Degrees above
    the last bucket take :func:`select.walk_transition_chunked_window`.

    Counted RNG as the reference: the bucket uniform is ``fold_in(key, 0)``
    and the tail's ``fold_in(key, 1)``, each drawn over all W walkers and
    sliced.  Returns next vertices (W,) int32, -1 for finished walkers and
    dead ends.
    """
    safe, starts, deg = ref.walker_rows(indptr, cur)
    r = uniform(fold_in(key, 0), (cur.shape[0],), device=cur.device)

    nxt = torch.full_like(cur, -1)
    lo = 0
    for i, seg in enumerate(buckets):
        # an understated max_degree degrades to neighborhood truncation (the
        # top cohort absorbs larger degrees, capped at its window), never
        # silent walker death
        absorb = i == len(buckets) - 1 and not use_chunked
        rows = torch.nonzero((deg > lo) & ((deg <= seg) | absorb)).squeeze(1)
        lo = seg
        if rows.numel() == 0:
            continue
        st = starts[rows]
        dg = torch.clamp(deg[rows], max=seg)
        bias = window_bias_rows(indices, weights, st, dg, rows, bias_of, seg)
        nxt[rows] = walk_step_window(st, dg, indices, bias, r[rows], max_seg=seg)

    if use_chunked:
        nxt = _chunked_tail(
            fold_in(key, 1), indptr, indices, safe, deg, buckets[-1], nxt,
            lambda huge, rows, rand: sel.walk_transition_chunked_window(
                None, indptr, indices, weights, rows,
                lambda sub, u, wt, m, e: bias_of(huge[sub], u, wt, m, e), chunk=CHUNK,
                rand=rand),
        )
    return nxt
