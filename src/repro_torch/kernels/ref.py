"""Plain PyTorch versions of the walk-step and selection kernels.

Each function computes what its CUDA kernel computes, with the same f32
arithmetic in the same order, so the two agree bit for bit; each is also
bit-identical to its ``repro.kernels.ref`` oracle and Pallas kernel.  The
kernel wrappers run these on CPU tensors; on the card they serve only as
the yardstick the kernels are checked against.

The step-level versions (:func:`walk_step_ref`, :func:`reject_step_ref`,
:func:`alias_step_ref`) take the step's key and the walkers' vertices, as their kernels do: they
draw the counted uniforms with ``kernels.threefry`` and run the cohort-level
versions (``*_block_ref``) on each cohort the ladder gives.

Unlike the TPU kernels, nothing here needs padded edge arrays: every read
lies inside a walker's own row ``[start, start + deg)``, and window
positions outside the row are masked to zero before they are read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.threefry import (
    BatchKeys,
    bits_to_unit_float,
    fold_in,
    threefry2x32,
    uniform,
    uniform_at,
    uniform_many,
)

_EPS = 1e-12
#: the BRS clip bound ``1 - 1e-12`` as JAX applies it to f32 (1.0)
_ONE_MINUS_EPS = float(np.float32(1.0 - _EPS))

#: block width of XLA-CPU's scan association (see :func:`blocked_cumsum`)
SCAN_BLOCK = 16

#: Rejection-sampling retry budget per walk step (counted-RNG rounds).  Under
#: the cost model's near-uniform guard (acceptance rate >= 0.75) the chance of
#: exhausting all rounds is <= 0.25**8 ~ 1.5e-5; exhaustion falls back to the
#: last candidate (still a real neighbor) rather than killing the walker.
REJECT_ITERS = 8

#: walkers per block of the ITS windows (bounds their (block, 2·seg) temporaries)
ROW_BLOCK = 1 << 18


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def padded_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums over the last axis, associated exactly as
    XLA-CPU's ``jnp.cumsum``, for any width: a recursive base-16 blocked
    scan.

    Sequential inside each 16-wide block; the block totals are scanned by the
    same rule; each block but the first then adds its exclusive prefix (the
    scanned total of the block before it) to its in-block sums.  Each level
    is zero-padded to a multiple of 16 first, as XLA pads it, which changes
    no prefix.  Blocks are counted from position 0 of ``x`` — for a
    walk-step window, the block origin ``start // seg * seg``, not the row
    start.  Written as explicit column adds, which round the same on every
    device (``torch.cumsum`` associates differently on both CPU and CUDA).
    """
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _sequential_cumsum(x)
    pad = (-n) % SCAN_BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    m = n + pad
    s = _sequential_cumsum(x.reshape(*x.shape[:-1], m // SCAN_BLOCK, SCAN_BLOCK))
    totals = padded_cumsum(s[..., SCAN_BLOCK - 1])
    out = torch.cat([s[..., :1, :], s[..., 1:, :] + totals[..., :-1, None]], dim=-2)
    return out.reshape(*x.shape[:-1], m)[..., :n]


#: entries of a chunk of the wide ``its_select`` kernel: 16^3, one node of
#: the scan's level 3, aligned at a multiple of itself
CHUNK = SCAN_BLOCK ** 3


def chunked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """:func:`padded_cumsum` over ``(n, P)`` rows as the wide ``its_select``
    kernel splits it, bit for bit: chunks of :data:`CHUNK` entries, each
    on its own, joined by a small table a row.

    A chunk aligned at a multiple of 4,096 holds whole nodes of levels 0-2
    and is one node of level 3.  So (phase A) each chunk takes its in-block
    sums at levels 0, 1 and 2 alone; (phase B) a row scans its chunk totals
    by :func:`padded_cumsum`'s rule (``t3``) and gives each chunk ``c`` the
    three prefixes the tree adds into it from outside: ``t3[c-1]``, the
    scanned value of the previous chunk's last level-2 node
    (``tot[c-1] + t3[c-2]``) and of its last level-1 node
    (``e1[c-1] + (e2[c-1] + t3[c-2])``); (phase C) each 16-block gets the
    one value the tree adds to its in-block sums, built from those with the
    tree's association, and (phase D) an entry is its in-block sum plus that
    value.  For tests only: the main path runs the kernel on the card and
    :func:`padded_cumsum` on the CPU.
    """
    n, p = x.shape
    w3 = -(-p // CHUNK)
    add = lambda a, b, cond: torch.where(cond, a + b, a)  # noqa: E731  (a, or a + b where the tree adds)
    # A: in-block sums of levels 0, 1, 2 of each chunk
    s0 = _sequential_cumsum(torch.nn.functional.pad(x, (0, w3 * CHUNK - p)).reshape(n, w3, 256, 16))
    s1 = _sequential_cumsum(s0[..., -1].reshape(n, w3, 16, 16)).reshape(n, w3, 256)
    s2 = _sequential_cumsum(s1.reshape(n, w3, 16, 16)[..., -1])
    tot, e1, e2 = s2[..., 15], s1[..., 255], s2[..., 14]
    # B: the level-3 scan and the three prefixes of each chunk
    t3 = padded_cumsum(tot)
    prev = lambda a, d: torch.nn.functional.pad(a, (d, 0))[:, :w3]  # noqa: E731  (a[c - d], 0 before)
    c = torch.arange(w3)
    two = c >= 2
    pre3 = prev(t3, 1)
    pre2 = add(prev(tot, 1), prev(t3, 2), two)
    pre1 = prev(e1, 1) + add(prev(e2, 1), prev(t3, 2), two)
    # C: the value each 16-block adds, from the chunk's sums and the table; D: the entries
    one = (c >= 1)[None, :, None]
    jm = torch.arange(255)  # block jb = jm + 1 adds level 1 up to jm
    im = (jm // 16)[None, None, :]
    lev2 = add(torch.nn.functional.pad(s2, (1, 0))[..., jm // 16], pre3[..., None], one)
    lev2 = torch.where(im == 0, pre2[..., None], lev2)
    blk = add(s1[..., :255], lev2, one | (im > 0))
    out = torch.cat([add(s0[:, :, :1], pre1[:, :, None, None], one[..., None]),
                     s0[:, :, 1:] + blk[..., None]], dim=2)
    return out.reshape(n, w3 * CHUNK)[:, :p]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """:func:`padded_cumsum` for the walk-step windows, whose widths need no
    padding: at most 16, or multiples of 16 whose block counts obey the same
    rule."""
    n = x.shape[-1]
    while n > SCAN_BLOCK:
        if n % SCAN_BLOCK:
            raise ValueError(f"blocked_cumsum needs a width <= 16 or a multiple of 16, got {x.shape[-1]}")
        n //= SCAN_BLOCK
    return padded_cumsum(x)


def compact_window_scan(row, local: int, seg: int) -> tuple[np.ndarray, np.float32]:
    """The scan of one ``walk_step_window`` row, touching only its own
    16-blocks: what the card kernel computes per walker.

    ``row`` holds the row's ``deg`` f32 values, which sit at offsets
    ``[local, local + deg)`` of a ``2·seg`` window of zeros (``deg <= seg``,
    ``local < seg``).  Returns the f32 prefixes at the row's positions and
    the window's total, both bit-equal to :func:`padded_cumsum` over the
    zero-filled window (for values other than ``-0.0``): the zeros around the
    row add exactly, so the blocks it does not touch need no work.  The
    running state is the in-block sum ``ps``, the sum of the current
    group's block totals ``gs``, the sum of the closed groups' totals
    ``top`` (16 blocks a group, counted from the window origin), and the
    scanned total before the current block ``bprev``.

    The total is the scan's value at position ``2·seg - 1``, which is not
    the last row prefix once there are several groups: a row that ends in
    group 1 of a 1024-wide window has the prefix ``t + (s + g0)`` there and
    the total ``g0 + (s + t)``.
    """
    vals = np.asarray(row, dtype=np.float32)
    deg = vals.shape[0]
    zero = np.float32(0.0)
    ps = gs = top = bprev = zero
    prefixes = np.empty(deg, np.float32)
    for c, v in enumerate(vals):
        q = local + c
        if c and q % SCAN_BLOCK == 0:  # a block closes
            gs = gs + ps
            bprev = gs + top
            if q % (SCAN_BLOCK * SCAN_BLOCK) == 0:  # and its group
                top = top + gs
                gs = zero
            ps = v
        else:
            ps = v if c == 0 else ps + v
        prefixes[c] = ps + bprev
    if deg == 0:
        return prefixes, zero
    if (local + deg - 1) // SCAN_BLOCK == 2 * seg // SCAN_BLOCK - 1:  # the row reaches the last block
        return prefixes, ps + bprev
    return prefixes, (gs + ps) + top


def _cap(degs: torch.Tensor, seg: int | None) -> torch.Tensor:
    return degs if seg is None else torch.clamp(degs, max=seg)


def _gather(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` with positions clamped into the array (dead walkers
    compute a throwaway position; live ones always lie inside their row)."""
    return table[pos.long().clamp(0, table.shape[0] - 1)]


def _window_pick(local, blk0, degs, mask, wts, rand, indices) -> torch.Tensor:
    """The ITS pick over block-aligned windows: the masked cumsum, the
    count of prefixes ``<= r·total``, and the neighbor id at that offset;
    -1 where the degree is 0 or the total is ``<= 1e-12``."""
    cum = blocked_cumsum(wts)
    total = cum[:, -1]
    target = rand * total
    pick = ((cum <= target[:, None]) & mask).sum(dim=-1, dtype=torch.int32)
    pick = torch.minimum(local + pick, local + torch.clamp(degs - 1, min=0))
    cand = _gather(indices, blk0 + pick)
    dead = (degs <= 0) | (total <= _EPS)
    return torch.where(dead, -1, cand).to(torch.int32)


def _block_window(starts: torch.Tensor, degs: torch.Tensor, seg: int):
    """Each row's place in its ``2·seg`` window from the block origin
    ``blk0 = start // seg * seg``: ``(local, blk0, offs, mask)``, the row at
    offsets ``[local, local + deg)``."""
    local = starts % seg
    offs = torch.arange(2 * seg, dtype=torch.int32, device=starts.device)
    mask = (offs >= local[:, None]) & (offs < (local + degs)[:, None])
    return local, starts - local, offs, mask


def walk_step_block_ref(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    rand: torch.Tensor,
    *,
    seg: int,
) -> torch.Tensor:
    """One flat-bias ITS cohort (``walk_step`` kernel): the pick of
    :func:`_window_pick` over the block-aligned ``2·seg`` window.

    starts/degs: (W,) int32 with ``degs <= seg``; indices/bias: flat CSR
    arrays (padded or not); rand: (W,) f32.  Returns (W,) int32.
    """
    local, blk0, offs, mask = _block_window(starts, degs, seg)
    wts = torch.where(mask, _gather(bias, blk0[:, None] + offs), 0.0)
    return _window_pick(local, blk0, degs, mask, wts, rand, indices)


def walk_step_window_block_ref(
    starts: torch.Tensor,
    degs: torch.Tensor,
    indices: torch.Tensor,
    bias_rows: torch.Tensor,
    rand: torch.Tensor,
    *,
    seg: int,
) -> torch.Tensor:
    """One window-bias ITS cohort (``walk_step_window`` kernel).

    ``bias_rows`` is ``(W, seg)`` f32, row-aligned: column ``j`` holds the
    computed bias of the walker's edge ``start + j`` (``j < deg``).  The
    values are placed at offset ``start % seg`` of the ``2·seg`` window —
    the reference's ``(W, 2·seg)`` operand, value for value — and picked as
    :func:`walk_step_block_ref` picks.
    """
    local, blk0, offs, mask = _block_window(starts, degs, seg)
    src = torch.clamp(offs - local[:, None], 0, seg - 1).long()
    wts = torch.where(mask, torch.gather(bias_rows, 1, src), 0.0)
    return _window_pick(local, blk0, degs, mask, wts, rand, indices)


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

    ``rej`` is the (W, iters, 2) budget of :func:`rejection_randoms`:
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


def rejection_randoms(
    key: np.ndarray, batch_shape, iters: int = REJECT_ITERS, device="cpu"
) -> torch.Tensor:
    """The rejection budget as a tensor: ``(W, iters, 2)`` f32 uniforms.

    Round ``t`` consumes ``uniform(fold_in(key, 2t))`` for the candidate
    slot and ``uniform(fold_in(key, 2t + 1))`` for the accept test — the
    reference's counted-RNG contract.  All ``2·iters`` draws hash in one
    pass, laid out walker-major.  The ``reject_step`` kernel hashes only the
    rounds each walker reaches; this is what its plain version reads.
    Under :class:`~repro_torch.kernels.threefry.BatchKeys` walker ``b``
    draws its rounds under its own keys at its own counter (its row's keys
    at its index in the row, or its depth's keys at its instance).
    """
    if iters < 1:
        raise ValueError(f"rejection budget needs at least one round, got iters={iters}")
    (n,) = tuple(batch_shape) if isinstance(batch_shape, (tuple, list)) else (batch_shape,)
    if isinstance(key, BatchKeys):  # each walker's rounds under its own keys
        if n != key.size:
            raise ValueError(f"rejection_randoms: keys of {key.size} walkers for {n}")
        rounds = key.table(*((t,) for t in range(2 * iters))).to(torch.int64) & 0xFFFFFFFF
        row, ctr = key.lanes()
        ctr = ctr[:, None]
        x0, x1 = threefry2x32(rounds[row, :, 0], rounds[row, :, 1], ctr >> 32, ctr & 0xFFFFFFFF)
        return bits_to_unit_float(x0 ^ x1).reshape(n, iters, 2).contiguous()
    keys = np.stack([fold_in(key, t) for t in range(2 * iters)])
    rs = uniform_many(keys, n, device=device)  # (2*iters, W)
    return rs.t().reshape(n, iters, 2).contiguous()


def walker_rows(indptr: torch.Tensor, cur: torch.Tensor):
    """``(safe, starts, deg)`` of walkers at ``cur``: the vertex as an index
    (0 for finished walkers), its row start, and its degree (0 for finished
    walkers)."""
    safe = torch.clamp(cur, min=0).long()
    starts = indptr[safe]
    return safe, starts, torch.where(cur >= 0, indptr[safe + 1] - starts, 0)


def walker_cohorts(deg: torch.Tensor, buckets: tuple, use_chunked: bool) -> torch.Tensor:
    """Each walker's degree cohort, as the step schedules it: ``i`` for the
    first bucket with ``deg <= buckets[i]``, ``len(buckets)`` for the
    huge-degree tail; without a tail the last bucket absorbs larger degrees
    (an understated ``max_degree`` truncates rows, never kills walkers).
    -1 for degree 0."""
    cohort = torch.full_like(deg, -1)
    lo = 0
    for i, seg in enumerate(buckets):
        absorb = i == len(buckets) - 1 and not use_chunked
        cohort = torch.where((deg > lo) & ((deg <= seg) | absorb), i, cohort)
        lo = seg
    if use_chunked:
        cohort = torch.where(deg > buckets[-1], len(buckets), cohort)
    return cohort


def _served(cur, indptr, buckets, use_chunked, methods, method, out):
    """The walkers of the cohorts planned as ``method``, by cohort:
    ``(safe, starts, deg, out, [(cohort index, cap or None, rows)])``."""
    safe, starts, deg = walker_rows(indptr, cur)
    if out is None:
        out = torch.full_like(cur, -1)
    cohort = walker_cohorts(deg, buckets, use_chunked)
    groups = []
    for k, m in enumerate(methods):
        if m == method:
            rows = torch.nonzero(cohort == k).squeeze(1)
            groups.append((k, buckets[k] if k < len(buckets) else None, rows))
    return safe, starts, deg, out, groups


def walk_step_ref(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
    key_path: tuple = (0,),
) -> torch.Tensor:
    """One flat-bias ITS step for the walkers of every bucket planned as
    ``"its"`` (``walk_step`` kernel; the ITS tail is the chunked scan, not
    this step).

    The uniform is ``uniform(fold_in(key, 0), (W,))`` (``key`` folded with
    each entry of ``key_path`` in turn), walker ``i`` at counter ``i``;
    each cohort's rows are capped at its segment and picked by
    :func:`walk_step_block_ref`, in blocks of :data:`ROW_BLOCK` walkers.
    Writes those walkers' next vertices (-1 for a dead end) into ``out``
    and leaves its other entries as they are; ``out=None`` starts from all
    -1.  Returns ``out``.
    """
    _, starts, deg, out, groups = _served(cur, indptr, buckets, use_chunked, methods, "its", out)
    for d in key_path:
        key = fold_in(key, d)
    r = uniform(key, (cur.shape[0],), device=cur.device)
    for _, seg, rows in groups:
        if seg is None:
            continue
        for b in range(0, rows.shape[0], ROW_BLOCK):
            blk = rows[b:b + ROW_BLOCK]
            out[blk] = walk_step_block_ref(starts[blk], torch.clamp(deg[blk], max=seg), indices,
                                           bias, r[blk], seg=seg)
    return out


def reject_step_ref(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    bias: torch.Tensor,
    row_max: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One counted-budget rejection step for the walkers of every cohort
    planned as ``"rejection"``, the tail included (``reject_step`` kernel).

    The budget is ``rejection_randoms(fold_in(key, 2), (W,))``, walker ``i``
    at counter ``i``; ``row_max`` is the ``(V,)`` per-vertex envelope.  A
    bucket cohort caps its rows at its segment, the tail draws over the
    whole row (:func:`reject_step_block_ref`).  Writes into ``out`` as
    :func:`walk_step_ref` does.  Returns ``out``.
    """
    safe, starts, deg, out, groups = _served(cur, indptr, buckets, use_chunked, methods,
                                             "rejection", out)
    rej = rejection_randoms(fold_in(key, 2), (cur.shape[0],), device=cur.device)
    for _, seg, rows in groups:
        out[rows] = reject_step_block_ref(starts[rows], deg[rows], indices, bias,
                                          row_max[safe[rows]], rej[rows], seg=seg)
    return out


def alias_step_ref(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    prob: torch.Tensor,
    alias: torch.Tensor,
    cur: torch.Tensor,
    *,
    buckets: tuple,
    use_chunked: bool,
    methods: tuple,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One O(1) alias step for the walkers of every cohort planned as
    ``"alias"``, the tail included (``alias_step`` kernel).

    A bucket cohort's uniform is ``uniform(fold_in(key, 0), (W,))``, the
    tail's ``uniform(fold_in(key, 1), (W,))``, walker ``i`` at counter
    ``i``; each is hashed at the cohort's walkers only.  A bucket cohort
    caps its rows at its segment, the tail draws over the whole row
    (:func:`alias_step_block_ref`).  Writes into ``out`` as
    :func:`walk_step_ref` does.  Returns ``out``.
    """
    _, starts, deg, out, groups = _served(cur, indptr, buckets, use_chunked, methods, "alias", out)
    for _, seg, rows in groups:
        r = uniform_at(fold_in(key, 0 if seg is not None else 1), rows)
        out[rows] = alias_step_block_ref(starts[rows], deg[rows], indices, prob, alias, r, seg=seg)
    return out


def its_select_ref(biases: torch.Tensor, rands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ITS + bipartite region search, K of P without replacement
    (``its_select`` kernel, ``its_select_pallas(..., with_stats=True)``).

    biases: (I, P) f32 (``<= 0`` unselectable); rands: (I, ITERS, K) f32,
    the counted retry budget.  The CTPS is ``cumsum(max(b, 0)) /
    max(total, 1e-12)`` (:func:`padded_cumsum`, counted from position 0).
    Round ``t`` draws ``r1``, searches its region (the count of CTPS
    entries ``<= r1``, clipped to ``P - 1``) and, when that region is
    taken, moves to ``r2 = r1·(1-δ)`` shifted past the region by ``δ`` and
    clipped to ``[0, 1]``; a candidate needs mass, and among equal
    candidates the lowest lane wins.  Returns ``(idx (I, K) int32, -1
    unfilled; stats (I, 2) int32 = (rounds with a pending draw, CTPS
    searches))``.
    """
    n, p = biases.shape
    iters, k = rands.shape[1], rands.shape[2]
    dev = biases.device
    b = torch.clamp(biases.to(torch.float32), min=0.0)
    sums = padded_cumsum(b)
    ctps = (sums / torch.clamp(sums[:, -1:], min=_EPS)).contiguous()
    lower = torch.cat([torch.zeros_like(ctps[:, :1]), ctps[:, :-1]], dim=-1)
    want = torch.clamp((b > 0).sum(dim=-1), max=k)
    lane = torch.arange(k, device=dev)
    beats = torch.tril(torch.ones(k, k, dtype=torch.bool, device=dev), diagonal=-1)
    done = lane >= want[:, None]
    out = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros((n, p + 1), dtype=torch.bool, device=dev)  # column p: losers
    rounds = torch.zeros(n, dtype=torch.int32, device=dev)
    searches = torch.zeros(n, dtype=torch.int32, device=dev)

    # the count of entries <= r does not depend on their order; the CTPS
    # itself can step down by a few ulps at a 16-block (the kernels' exact_count)
    bounds = torch.sort(ctps, dim=-1).values

    def search(r):
        return torch.clamp(torch.searchsorted(bounds, r.contiguous(), right=True), max=p - 1)

    for it in range(iters):
        pending = ~done
        if not bool(pending.any()):
            break  # no draw pending: later rounds change nothing
        r1 = rands[:, it, :]
        idx1 = search(r1)
        hit1 = torch.gather(taken, 1, idx1)
        rounds += pending.any(dim=-1).to(torch.int32)
        searches += pending.sum(dim=-1, dtype=torch.int32) + (pending & hit1).sum(dim=-1, dtype=torch.int32)
        lo = torch.gather(lower, 1, idx1)
        delta = torch.gather(ctps, 1, idx1) - lo
        r2 = r1 * (1.0 - delta)
        r2 = torch.clamp(torch.where(r2 < lo, r2, r2 + delta), 0.0, _ONE_MINUS_EPS)
        idx2 = search(r2)
        hit2 = torch.gather(taken, 1, idx2)
        cand = torch.where(hit1, idx2, idx1)
        ok = ~done & ~torch.where(hit1, hit2, hit1) & (torch.gather(b, 1, cand) > 0)
        same = (cand[:, :, None] == cand[:, None, :]) & ok[:, :, None] & ok[:, None, :]
        win = ok & ~(same & beats).any(dim=-1)
        out = torch.where(win, cand.to(torch.int32), out)
        taken.scatter_(1, torch.where(win, cand, p), True)
        done = done | win
    return out, torch.stack([rounds, searches], dim=-1)
