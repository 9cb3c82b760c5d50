"""Bias-based vertex selection for flat-bias walks (paper §II-B, §IV).

The flat parts of ``repro.core.select``:

- the chunked two-pass ITS scan for rows above the top degree bucket
  (:func:`walk_transition_chunked`);
- the adaptive runtime's O(1) methods: alias tables (:func:`build_alias`,
  host numpy) and rejection envelopes (:func:`build_row_max`), their
  counted random budget (:func:`rejection_randoms`) and their uncapped
  draws (:func:`alias_draw_flat`, :func:`rejection_draw_flat`), which run
  the ``alias_step`` / ``reject_step`` kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rng import fold_in, uniform, uniform_many
from repro_torch.kernels import ref
from repro_torch.kernels.alias_select import alias_step
from repro_torch.kernels.walk_step import reject_step

#: Rejection-sampling retry budget per walk step (counted-RNG rounds).  Under
#: the cost model's near-uniform guard (acceptance rate >= 0.75) the chance of
#: exhausting all rounds is <= 0.25**8 ~ 1.5e-5; exhaustion falls back to the
#: last candidate (still a real neighbor) rather than killing the walker.
REJECT_ITERS = 8

#: width of XLA-CPU's partial sums in a row reduction (see :func:`row_sum`)
SUM_WINDOW = 32


def row_sum(w: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, associated as XLA-CPU's f32 ``jnp.sum`` of a
    512-wide row: sequential inside each 32-wide window, then sequential over
    the window sums.  Explicit column adds, so every device rounds alike."""
    n = w.shape[-1]
    if n % SUM_WINDOW:
        raise ValueError(f"row_sum needs a multiple of {SUM_WINDOW}, got {n}")
    parts = w.reshape(*w.shape[:-1], n // SUM_WINDOW, SUM_WINDOW)
    acc = parts[..., 0]
    for j in range(1, SUM_WINDOW):
        acc = acc + parts[..., j]
    total = acc[..., 0]
    for b in range(1, acc.shape[-1]):
        total = total + acc[..., b]
    return total


def walk_transition_chunked(
    key: np.ndarray,
    indptr: torch.Tensor,
    weights: torch.Tensor,
    cur: torch.Tensor,
    chunk: int = 512,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """One weighted ITS draw per walker over arbitrarily large rows.

    Two-pass chunked scan: pass 1 accumulates each row's total chunk by
    chunk, pass 2 finds the first edge whose running sum exceeds
    ``r * total``.  Returns the edge offset within each row (int32), -1 for
    a dead end.  The loops run to the longest row among ``cur`` only, so
    callers pass just the walkers that need the scan.  ``rand`` overrides
    the uniforms ``uniform(key, cur.shape)``.
    """
    dev = cur.device
    n = cur.shape[0]
    cur = cur.long()
    start = indptr[cur].long()
    deg = indptr[cur + 1].long() - start
    if rand is None:
        rand = uniform(key, (n,), device=dev)
    nchunks = max((int(deg.max()) + chunk - 1) // chunk, 1) if n else 0
    offs = torch.arange(chunk, device=dev)

    def chunk_weights(c):
        pos = c * chunk + offs
        m = pos < deg[:, None]
        eidx = torch.where(m, start[:, None] + pos, 0)
        return torch.where(m, weights[eidx], 0.0), m

    total = torch.zeros(n, dtype=torch.float32, device=dev)
    for c in range(nchunks):
        total = total + row_sum(chunk_weights(c)[0])
    target = rand * total

    cum = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c in range(nchunks):
        w, m = chunk_weights(c)
        cw = ref.blocked_cumsum(w) + cum[:, None]
        hit = (cw > target[:, None]) & m & (found[:, None] < 0)
        first = hit.to(torch.uint8).argmax(dim=-1) + c * chunk
        found = torch.where((found < 0) & hit.any(dim=-1), first, found)
        cum = cw[:, -1]
    live = (deg > 0) & (total > 0)
    # numerical edge: r*total == total -> take the last edge of the row
    found = torch.where((found < 0) & live, deg - 1, found)
    return torch.where(live, found, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# Alias tables (Vose) and rejection sampling — host-side construction,
# identical to the reference's numpy code, so the tables are identical too.
# ---------------------------------------------------------------------------


def build_alias(indptr, bias) -> tuple[np.ndarray, np.ndarray]:
    """Per-row alias tables over a flat CSR bias array (Vose's method).

    Vectorized over rows grouped by exact degree: each group forms an
    ``(R, d)`` matrix and the small/large pairing loop retires one column per
    iteration for every row simultaneously.  Internally float64; returns
    ``(prob, alias)``: ``prob`` float32 ``(E,)`` acceptance thresholds,
    ``alias`` int32 ``(E,)`` row-LOCAL redirect offsets.  Zero-total rows get
    ``prob = 0`` / ``alias = -1``.  Deterministic: numpy argmax first-index
    tie-breaks.
    """
    indptr = np.asarray(indptr)
    bias = np.maximum(np.asarray(bias, dtype=np.float64), 0.0)
    e = bias.shape[0]
    deg = np.diff(indptr).astype(np.int64)
    prob_out = np.zeros(e, dtype=np.float32)
    alias_out = np.full(e, -1, dtype=np.int32)
    for d in np.unique(deg):
        if d <= 0:
            continue
        d = int(d)
        starts = indptr[:-1][deg == d].astype(np.int64)
        w = bias[starts[:, None] + np.arange(d)[None, :]]  # (R, d)
        tot = w.sum(axis=1)
        ok = tot > 0.0
        if not ok.any():
            continue
        starts, w, tot = starts[ok], w[ok], tot[ok]
        r = starts.shape[0]
        p = w * (d / tot[:, None])  # scaled to sum d
        alias = np.full((r, d), -1, dtype=np.int32)
        active = np.ones((r, d), dtype=bool)
        for _ in range(max(d - 1, 0)):
            small = active & (p < 1.0)
            large = active & (p >= 1.0)
            has = small.any(axis=1) & large.any(axis=1)
            if not has.any():
                break
            rows = np.nonzero(has)[0]
            s = np.argmax(small[rows], axis=1)  # first active small
            g = np.argmax(large[rows], axis=1)  # first active large
            alias[rows, s] = g
            active[rows, s] = False
            p[rows, g] -= 1.0 - p[rows, s]
        # leftovers (all-large or all-small residue): certain acceptance
        lr, lc = np.nonzero(active)
        p[lr, lc] = 1.0
        alias[lr, lc] = lc
        flat = (starts[:, None] + np.arange(d)[None, :]).ravel()
        prob_out[flat] = p.astype(np.float32).ravel()
        alias_out[flat] = alias.ravel()
    return prob_out, alias_out


def build_row_max(indptr, bias) -> np.ndarray:
    """Per-vertex max bias, ``(V,)`` float32 — the rejection envelope."""
    indptr = np.asarray(indptr)
    bias = np.maximum(np.asarray(bias, dtype=np.float64), 0.0)
    deg = np.diff(indptr)
    if bias.shape[0] == 0:
        return np.zeros(deg.shape[0], dtype=np.float32)
    starts = np.minimum(indptr[:-1], bias.shape[0] - 1)
    rm = np.maximum.reduceat(bias, starts)
    return np.where(deg > 0, rm, 0.0).astype(np.float32)


def rejection_randoms(
    key: np.ndarray, batch_shape, iters: int = REJECT_ITERS, device="cpu"
) -> torch.Tensor:
    """Pre-generated rejection budget: ``(W, iters, 2)`` f32 uniforms.

    Round ``t`` consumes ``uniform(fold_in(key, 2t))`` for the candidate
    slot and ``uniform(fold_in(key, 2t + 1))`` for the accept test — the
    reference's counted-RNG contract.  All ``2·iters`` draws hash in one
    pass; the result is laid out walker-major, the contiguous 16 floats per
    walker that the ``reject_step`` kernel reads.
    """
    if iters < 1:
        raise ValueError(f"rejection budget needs at least one round, got iters={iters}")
    (n,) = tuple(batch_shape) if isinstance(batch_shape, (tuple, list)) else (batch_shape,)
    keys = np.stack([fold_in(key, t) for t in range(2 * iters)])
    rs = uniform_many(keys, n, device=device)  # (2*iters, W)
    return rs.t().reshape(n, iters, 2).contiguous()


def alias_draw_flat(
    starts: torch.Tensor,
    degs: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    indices: torch.Tensor,
    rand: torch.Tensor,
    *,
    cap: int | None = None,
) -> torch.Tensor:
    """One O(1) alias draw per walker from flat CSR-aligned tables.

    ``cap`` truncates rows to a bucket segment; ``None`` (the huge-degree
    tail) draws over the whole row.  Runs the ``alias_step`` kernel on the
    card.  Returns next vertices (int32), -1 for dead ends.
    """
    return alias_step(starts, degs, indices, prob, alias, rand, max_seg=cap)


def rejection_draw_flat(
    starts: torch.Tensor,
    degs: torch.Tensor,
    flat_bias: torch.Tensor,
    row_max: torch.Tensor,
    indices: torch.Tensor,
    rej: torch.Tensor,
    *,
    cap: int | None = None,
) -> torch.Tensor:
    """Counted-RNG rejection draw per walker over flat CSR bias.

    ``rej`` is the ``(W, iters, 2)`` budget from :func:`rejection_randoms`;
    ``row_max`` is each walker's envelope.  ``cap`` as in
    :func:`alias_draw_flat`.  Runs the ``reject_step`` kernel on the card.
    """
    return reject_step(starts, degs, indices, flat_bias, row_max, rej, max_seg=cap)
