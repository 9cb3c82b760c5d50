"""Degree-bucketed walk scheduling with a per-cohort selection method.

Per step, walkers are split by degree into cohorts — ``(0, 128]`` and
``(128, 512]`` — each served by one walk-step kernel with a per-cohort row
cap, and degrees above the top bucket take a tail (the workload-aware
scheduling of the paper, as ``repro.core.backend`` runs it).

There is one scheduler, :func:`walk_step_adaptive`; the device of its
tensors decides what runs.  On the card every cohort launches its CUDA
kernel (ITS, alias or rejection); on the CPU the kernels' plain versions
run.  An all-ITS plan is ``methods=("its", …)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import select as sel
from repro_torch.core.rng import fold_in, uniform
from repro_torch.kernels.alias_select import alias_step
from repro_torch.kernels.walk_step import reject_step, walk_step

#: default degree-bucket ladder for the walk fast path:
#: deg ∈ (0, 128] → small cohort, (128, 512] → medium cohort, > 512 → tail
WALK_BUCKETS = (128, 512)

#: chunk width of the two-pass huge-degree ITS scan
CHUNK = 512


def walk_bucket_plan(max_degree: int, segs: tuple = WALK_BUCKETS) -> tuple[tuple, bool]:
    """Static per-graph schedule: kernel segment sizes + need for the tail.

    Returns ``(buckets, use_chunked)``: one cohort per bucket segment the
    graph can populate, plus the huge-degree tail for degrees above the last
    segment.
    """
    buckets = []
    lo = 0
    for s in segs:
        if max_degree > lo:
            buckets.append(s)
        lo = s
    if not buckets:
        buckets = [segs[0]]
    return tuple(buckets), max_degree > segs[-1]


def _chunked_tail(key, indptr, indices, flat_bias, safe, deg, seg_hi, nxt):
    """Route walkers with ``deg > seg_hi`` through the two-pass chunked scan
    (only those walkers: the scan runs to their longest row)."""
    huge = torch.nonzero(deg > seg_hi).squeeze(1)
    if huge.numel() == 0:
        return nxt
    rand = uniform(key, (nxt.shape[0],), device=nxt.device)[huge]
    rows = safe[huge]
    off = sel.walk_transition_chunked(key, indptr, flat_bias, rows, chunk=CHUNK, rand=rand)
    eidx = torch.clamp(indptr[rows].long() + torch.clamp(off, min=0), 0, indices.shape[0] - 1)
    cand = torch.where(off >= 0, indices[eidx], -1)
    nxt = nxt.clone()
    nxt[huge] = cand
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
    plus one for the tail when present.

    Counted RNG, as the reference: the bucket uniform is ``fold_in(key, 0)``
    (alias cohorts consume the same uniform an ITS cohort would); the ITS
    and alias tails use ``fold_in(key, 1)``; the rejection budget, shared by
    every rejection cohort including the tail, is
    ``rejection_randoms(fold_in(key, 2))``.  Alias and rejection tails draw
    over the whole row; only an ITS tail scans.  Returns next vertices
    (W,) int32, -1 for finished walkers and dead ends.
    """
    dev = cur.device
    w = cur.shape[0]
    safe = torch.clamp(cur, min=0).long()
    starts = indptr[safe]
    deg = torch.where(cur >= 0, indptr[safe + 1] - starts, 0)
    r = uniform(fold_in(key, 0), (w,), device=dev)
    rej = None
    if any(m == "rejection" for m in methods):
        rej = sel.rejection_randoms(fold_in(key, 2), (w,), device=dev)
    rmv = None
    if tables.row_max is not None:
        rmv = torch.where(cur >= 0, tables.row_max[safe], 0.0)

    nxt = torch.full_like(cur, -1)
    lo = 0
    for i, seg in enumerate(buckets):
        # an understated max_degree degrades to neighborhood truncation
        # (each draw caps the row at seg), never silent walker death
        absorb = i == len(buckets) - 1 and not use_chunked
        inb = (deg > lo) & ((deg <= seg) | absorb)
        st = torch.where(inb, starts, 0)
        dg = torch.where(inb, deg, 0)
        m = methods[i]
        if m == "alias":
            cand = alias_step(st, dg, indices, tables.prob, tables.alias, r, max_seg=seg)
        elif m == "rejection":
            cand = reject_step(st, dg, indices, flat_bias, rmv, rej, max_seg=seg)
        else:
            cand = walk_step(st, torch.clamp(dg, max=seg), indices, flat_bias, r, max_seg=seg)
        nxt = torch.where(inb, cand, nxt)
        lo = seg

    if use_chunked:
        huge = deg > buckets[-1]
        st = torch.where(huge, starts, 0)
        dg = torch.where(huge, deg, 0)
        m = methods[len(buckets)]
        if m == "alias":
            tail_rand = uniform(fold_in(key, 1), (w,), device=dev)
            cand = sel.alias_draw_flat(st, dg, tables.prob, tables.alias, indices, tail_rand)
            nxt = torch.where(huge, cand, nxt)
        elif m == "rejection":
            cand = sel.rejection_draw_flat(st, dg, flat_bias, rmv, indices, rej)
            nxt = torch.where(huge, cand, nxt)
        else:
            nxt = _chunked_tail(
                fold_in(key, 1), indptr, indices, flat_bias, safe, deg, buckets[-1], nxt
            )
    return nxt
