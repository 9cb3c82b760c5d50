"""Plain PyTorch versions of the walk-step kernels.

Each function computes what its CUDA kernel computes, with the same f32
arithmetic in the same order, so the two agree bit for bit; each is also
bit-identical to its ``repro.kernels.ref`` oracle and Pallas kernel.  The
kernel wrappers run these on CPU tensors; on the card they serve only as
the yardstick the kernels are checked against.

Unlike the TPU kernels, nothing here needs padded edge arrays: every read
lies inside a walker's own row ``[start, start + deg)``, and window
positions outside the row are masked to zero before they are read.
"""
from __future__ import annotations

import torch

_EPS = 1e-12

#: block width of XLA-CPU's scan association (see :func:`blocked_cumsum`)
SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums over the last axis, associated exactly as
    XLA-CPU's ``jnp.cumsum``: a recursive base-16 blocked scan.

    Sequential inside each 16-wide block; the block totals are scanned by the
    same rule; each block but the first then adds its exclusive prefix (the
    scanned total of the block before it) to its in-block sums.  Blocks are
    counted from position 0 of ``x`` — for a walk-step window, the block
    origin ``start // seg * seg``, not the row start.  Written as explicit
    column adds, which round the same on every device (``torch.cumsum``
    associates differently on both CPU and CUDA).  Widths of at most 16, or
    multiples of 16 whose block counts obey the same rule, are accepted.
    """
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _sequential_cumsum(x)
    if n % SCAN_BLOCK:
        raise ValueError(f"blocked_cumsum needs a width <= 16 or a multiple of 16, got {n}")
    s = _sequential_cumsum(x.reshape(*x.shape[:-1], n // SCAN_BLOCK, SCAN_BLOCK))
    totals = blocked_cumsum(s[..., SCAN_BLOCK - 1])
    out = torch.cat([s[..., :1, :], s[..., 1:, :] + totals[..., :-1, None]], dim=-2)
    return out.reshape(x.shape)


def _cap(degs: torch.Tensor, seg: int | None) -> torch.Tensor:
    return degs if seg is None else torch.clamp(degs, max=seg)


def _gather(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` with positions clamped into the array (dead walkers
    compute a throwaway position; live ones always lie inside their row)."""
    return table[pos.long().clamp(0, table.shape[0] - 1)]


def walk_step_block_ref(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    rand: torch.Tensor,
    *,
    seg: int,
) -> torch.Tensor:
    """One flat-bias ITS cohort (``walk_step`` kernel): the masked cumsum
    over the block-aligned ``2·seg`` window, the count of prefixes
    ``<= r·total``, and the neighbor id at that offset; -1 where the degree
    is 0 or the total is ``<= 1e-12``.

    starts/degs: (W,) int32 with ``degs <= seg``; indices/bias: flat CSR
    arrays (padded or not); rand: (W,) f32.  Returns (W,) int32.
    """
    width = 2 * seg
    local = starts % seg
    blk0 = starts - local
    offs = torch.arange(width, dtype=torch.int32, device=starts.device)
    mask = (offs >= local[:, None]) & (offs < (local + degs)[:, None])
    wts = torch.where(mask, _gather(bias, blk0[:, None] + offs), 0.0)
    cum = blocked_cumsum(wts)
    total = cum[:, -1]
    target = rand * total
    pick = ((cum <= target[:, None]) & mask).sum(dim=-1, dtype=torch.int32)
    pick = torch.minimum(local + pick, local + torch.clamp(degs - 1, min=0))
    cand = _gather(indices, blk0 + pick)
    dead = (degs <= 0) | (total <= _EPS)
    return torch.where(dead, -1, cand).to(torch.int32)


def alias_step_block_ref(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    rand: torch.Tensor,
    *,
    seg: int | None,
) -> torch.Tensor:
    """One O(1) alias draw per walker (``alias_step`` kernel).

    ``u = r·deg``, ``slot = min(⌊u⌋, deg-1)``, ``coin = u - slot``: keep the
    slot if ``coin < prob[slot]``, else take the row-local ``alias[slot]``.
    Rows longer than ``seg`` truncate to it (``seg=None``: no cap, the
    huge-degree tail).  -1 for a zero degree or a zero-total row
    (``alias = -1``).
    """
    deg_eff = _cap(degs, seg)
    hi = torch.clamp(deg_eff - 1, min=0)
    u = rand * deg_eff.to(torch.float32)
    slot = torch.minimum(u.to(torch.int32), hi)
    frac = u - slot.to(torch.float32)
    pos = starts + slot
    a = _gather(alias, pos)
    chosen = torch.where(frac < _gather(prob, pos), slot, a)
    chosen = torch.minimum(torch.clamp(chosen, min=0), hi)
    nxt = _gather(indices, starts + chosen)
    dead = (degs <= 0) | (a < 0)
    return torch.where(dead, -1, nxt).to(torch.int32)


def reject_step_block_ref(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    row_max: torch.Tensor,
    rej: torch.Tensor,
    *,
    seg: int | None,
) -> torch.Tensor:
    """One counted-budget rejection draw per walker (``reject_step`` kernel).

    ``rej`` is the (W, iters, 2) budget of ``core.select.rejection_randoms``:
    round ``t`` proposes ``slot = ⌊r_slot·deg⌋`` and accepts iff
    ``r_acc·row_max < bias[slot]``.  The first acceptance wins; an exhausted
    budget keeps the last proposal if it carries mass.  -1 for a zero
    degree, a zero envelope or no candidate.  ``seg`` caps the row as in
    :func:`alias_step_block_ref`.
    """
    iters = rej.shape[1]
    deg_eff = _cap(degs, seg)
    degf = deg_eff.to(torch.float32)
    hi = torch.clamp(deg_eff - 1, min=0)
    chosen = torch.full_like(starts, -1)
    done = torch.zeros(starts.shape, dtype=torch.bool, device=starts.device)
    last = torch.zeros_like(starts)
    last_b = torch.zeros(starts.shape, dtype=torch.float32, device=starts.device)
    for t in range(iters):
        slot = torch.minimum((rej[:, t, 0] * degf).to(torch.int32), hi)
        bval = _gather(bias, starts + slot)
        acc = rej[:, t, 1] * row_max < bval
        chosen = torch.where(~done & acc, slot, chosen)
        last, last_b = slot, bval
        done = done | acc
    chosen = torch.where(done, chosen, torch.where(last_b > 0, last, -1))
    nxt = _gather(indices, starts + torch.clamp(chosen, min=0))
    dead = (degs <= 0) | (row_max <= 0) | (chosen < 0)
    return torch.where(dead, -1, nxt).to(torch.int32)
