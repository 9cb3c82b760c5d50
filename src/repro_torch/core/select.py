"""Bias-based vertex selection (paper §II-B, §IV), as ``repro.core.select``:

- the CTPS and ITS draw with replacement (:func:`build_ctps`,
  :func:`its_search`, :func:`select_with_replacement`);
- selection of K distinct candidates without replacement
  (:func:`select_without_replacement`): ITS with bipartite region search
  (``its_brs``) or fresh re-draws (``repeated``) under the counted retry
  loop, the CTPS recomputed after every pick (``updated``), or Gumbel top-k
  (``gumbel``); the retry budget as a tensor (:func:`retry_randoms`) is
  what the ``its_select`` kernel takes;
- the chunked two-pass ITS scan for rows above the top degree bucket, over
  a flat bias (:func:`walk_transition_chunked`) or a window-bias hook
  (:func:`walk_transition_chunked_window`);
- the adaptive runtime's O(1) methods: alias tables (:func:`build_alias`,
  host numpy) and rejection envelopes (:func:`build_row_max`); the draws
  themselves are the ``alias_step`` and ``reject_step`` kernels, and the
  rejection budget as a tensor (``kernels.ref.rejection_randoms``) is their
  plain versions'.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.rng import fold_in, gumbel, uniform, uniform_many, xla_log
from repro_torch.kernels import ref

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


def build_ctps(biases: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inclusive normalized prefix sum of biases: the CTPS (paper Eq. 1).

    Region of candidate ``j`` is ``[ctps[j-1], ctps[j])``; masked and
    zero-bias candidates get zero-width regions.  The scan is
    ``kernels.ref.padded_cumsum``, XLA-CPU's association for any width.
    """
    if mask is not None:
        biases = torch.where(mask, biases, 0.0)
    sums = ref.padded_cumsum(torch.clamp(biases.to(torch.float32), min=0.0))
    return sums / torch.clamp(sums[..., -1:], min=ref._EPS)


def its_search(ctps: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index of the CTPS region holding each ``r``: the count of region
    bounds ``<= r`` (``r`` is ``ctps.shape[:-1] + (k,)``), clipped.  Past
    256 entries the scan's association can leave the start of a 16-block a
    few ulps below the end of the block before, so the bounds are sorted
    first (the count does not depend on their order) and the count is
    their upper bound, without the reference's ``(..., k, p)`` compare."""
    bounds = torch.sort(ctps, dim=-1).values
    idx = torch.searchsorted(bounds, r.contiguous(), right=True)
    return torch.clamp(idx, max=ctps.shape[-1] - 1).to(torch.int32)


def select_with_replacement(key, biases: torch.Tensor, mask: torch.Tensor | None,
                            k: int) -> torch.Tensor:
    """ITS selection *with* replacement (random-walk case, paper Table I):
    ``k`` draws per instance from ``uniform(key, batch + (k,))``."""
    ctps = build_ctps(biases, mask)
    r = uniform(key, tuple(ctps.shape[:-1]) + (k,), device=ctps.device)
    return its_search(ctps, r)


class SelectResult(NamedTuple):
    indices: torch.Tensor  # (..., k) int32, -1 where selection failed/invalid
    valid: torch.Tensor  # (..., k) bool
    iters: torch.Tensor  # (...,) int32: retry-loop trip count (paper Fig. 11)
    searches: torch.Tensor  # (...,) int32: total CTPS searches (paper Fig. 12)
    #: True when a method without a kernel ran in plain PyTorch on the card
    fell_back: bool = False


def _dedup_priority(cand: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Within-round conflict resolution: among active draws of one
    candidate the lowest lane wins (the reference's K x K equality matrix
    under a lower-triangular priority).  Returns the winners' mask."""
    k = cand.shape[-1]
    eq = cand[..., :, None] == cand[..., None, :]
    both = active[..., :, None] & active[..., None, :]
    lower = torch.tril(torch.ones(k, k, dtype=torch.bool, device=cand.device), diagonal=-1)
    return active & ~(eq & both & lower).any(dim=-1)


def retry_randoms(key, batch_shape: tuple, iters: int, k: int, device="cpu",
                  offset: int = 0) -> torch.Tensor:
    """The counted retry budget: ``(..., iters, k)`` uniforms whose round
    ``t`` holds the bits the retry loop draws in round ``t``,
    ``uniform(fold_in(key, t), batch + (k,))``.  One hash over all rounds
    (``uniform_many``).  ``offset`` is the batch's first row in a larger
    batch: the rows then draw their share of that batch's bits."""
    if iters < 1:
        raise ValueError(f"retry budget needs at least one round, got iters={iters}")
    n = int(np.prod(batch_shape)) * k
    keys = np.stack([fold_in(key, t) for t in range(iters)])
    r = uniform_many(keys, n, device=device, offset=offset * k)
    return r.reshape(iters, *batch_shape, k).movedim(0, -2).contiguous()


def _masked(biases: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    b = torch.clamp(biases.to(torch.float32), min=0.0)
    return b if mask is None else torch.where(mask, b, 0.0)


def select_without_replacement(key, biases: torch.Tensor, mask: torch.Tensor | None, k: int,
                               method: str = "its_brs", max_iters: int = 32,
                               offset: int = 0) -> SelectResult:
    """Select ``k`` distinct candidates with probability proportional to
    bias, ``repro.core.select.select_without_replacement`` in plain PyTorch.

    biases: (..., P); mask: (..., P) bool or None; returns indices
    (..., k), -1 and invalid where fewer than k candidates are selectable.
    ``offset`` is the first row of ``biases`` in the batch the key's draws
    cover (the engine selects a batch in blocks of rows).
    """
    if method == "gumbel":
        return _select_gumbel(key, biases, mask, k, offset)
    if method == "updated":
        return _select_updated(key, biases, mask, k, offset)
    if method not in ("its_brs", "repeated"):
        raise ValueError(f"unknown selection method {method!r}")
    return _select_its_loop(key, biases, mask, k, use_brs=method == "its_brs",
                            max_iters=max_iters, offset=offset)


def _select_gumbel(key, biases, mask, k, offset=0) -> SelectResult:
    """Gumbel top-k (Plackett-Luce): the k largest ``log(b) + g``, ties to
    the lower index as ``lax.top_k`` breaks them."""
    b = _masked(biases, mask)
    if k > b.shape[-1]:
        raise ValueError(f"gumbel top-k needs k <= P, got k={k} and P={b.shape[-1]}")
    logits = xla_log(torch.clamp(b, min=ref._EPS))
    logits = torch.where(b > 0, logits, float("-inf"))
    g = gumbel(key, b.shape, device=b.device, offset=offset * b.shape[-1])
    keys = torch.where(torch.isfinite(logits), logits + g, float("-inf"))
    idx = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    navail = (b > 0).sum(dim=-1)
    valid = torch.arange(k, device=b.device) < navail[..., None]
    idx = torch.where(valid, idx, -1).to(torch.int32)
    zeros = torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device)
    return SelectResult(idx, valid, zeros + 1, zeros + k)


def _select_updated(key, biases, mask, k, offset=0) -> SelectResult:
    """Paper Fig. 6(b): the CTPS recomputed after every selection."""
    b = _masked(biases, mask)
    batch = b.shape[:-1]
    b_cur = b.reshape(-1, b.shape[-1]).clone()
    n = b_cur.shape[0]
    out = torch.full((n, k), -1, dtype=torch.int32, device=b.device)
    valid = torch.zeros((n, k), dtype=torch.bool, device=b.device)
    for i in range(k):
        ctps = build_ctps(b_cur)
        r = uniform(fold_in(key, i), (n, 1), device=b.device, offset=offset)
        idx = its_search(ctps, r).long()
        ok = torch.gather(b_cur, 1, idx)[:, 0] > 0
        out[:, i] = torch.where(ok, idx[:, 0].to(torch.int32), -1)
        valid[:, i] = ok
        b_cur.scatter_(1, idx, 0.0)  # b * (1 - one_hot(idx)), for b >= 0
    zeros = torch.zeros(batch, dtype=torch.int32, device=b.device)
    return SelectResult(out.reshape(*batch, k), valid.reshape(*batch, k), zeros + k, zeros + k)


def _select_its_loop(key, biases, mask, k, *, use_brs: bool, max_iters: int,
                     offset: int = 0) -> SelectResult:
    """ITS without replacement with the paper's retry loop (Fig. 5 lines
    9-14).  Each round every pending draw takes a fresh uniform; a draw that
    hits a selected region re-draws next round (``repeated``) or, with
    bipartite region search, moves to ``r2 = r1·(1-δ)`` shifted past the
    region and searches once more in the same round (``its_brs``).
    ``iters`` counts the rounds an instance had a pending draw, ``searches``
    its CTPS searches, as the reference counts them.  The selected set is a
    scatter into a ``(n, p + 1)`` map (column p takes the losers), not the
    reference's ``(n, k, p)`` one-hot.
    """
    b = _masked(biases, mask)
    batch, p = b.shape[:-1], b.shape[-1]
    b = b.reshape(-1, p)
    n, dev = b.shape[0], b.device
    ctps = build_ctps(b).contiguous()
    lower = torch.cat([torch.zeros_like(ctps[:, :1]), ctps[:, :-1]], dim=-1)
    want = torch.clamp((b > 0).sum(dim=-1), max=k)
    lane = torch.arange(k, device=dev)
    done = lane >= want[:, None]
    out = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros((n, p + 1), dtype=torch.bool, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    searches = torch.zeros(n, dtype=torch.int32, device=dev)
    for it in range(max_iters):
        pending = ~done
        if not bool(pending.any()):
            break
        r1 = uniform(fold_in(key, it), (n, k), device=dev, offset=offset * k)
        idx1 = its_search(ctps, r1).long()
        hit1 = torch.gather(taken, 1, idx1)
        searches += pending.sum(dim=-1, dtype=torch.int32)
        if use_brs:
            lo = torch.gather(lower, 1, idx1)
            delta = torch.gather(ctps, 1, idx1) - lo
            r2 = r1 * (1.0 - delta)
            r2 = torch.clamp(torch.where(r2 < lo, r2, r2 + delta), 0.0, ref._ONE_MINUS_EPS)
            idx2 = its_search(ctps, r2).long()
            hit2 = torch.gather(taken, 1, idx2)
            searches += (pending & hit1).sum(dim=-1, dtype=torch.int32)
            cand = torch.where(hit1, idx2, idx1)
            ok = pending & ~torch.where(hit1, hit2, hit1)
        else:
            cand, ok = idx1, pending & ~hit1
        ok = ok & (torch.gather(b, 1, cand) > 0)
        win = _dedup_priority(cand, ok)
        out = torch.where(win, cand.to(torch.int32), out)
        taken.scatter_(1, torch.where(win, cand, p), True)
        done_new = done | win
        exhausted = done_new.sum(dim=-1) >= want
        done_new = done_new | (exhausted[:, None] & (lane >= want[:, None]))
        iters += pending.any(dim=-1).to(torch.int32)
        done = done_new
    return SelectResult(out.reshape(*batch, k), (out >= 0).reshape(*batch, k),
                        iters.reshape(batch), searches.reshape(batch))


#: rows per block of a chunked scan: (block, chunk) temporaries at any W
ROW_BLOCK = 1 << 18


def _chunked_scan(deg: torch.Tensor, rand: torch.Tensor, chunk: int, chunk_bias) -> torch.Tensor:
    """Two-pass chunked ITS: pass 1 totals each row chunk by chunk
    (:func:`row_sum`), pass 2 finds the first edge whose running sum
    (:func:`~repro_torch.kernels.ref.blocked_cumsum`) exceeds ``r·total``.

    ``chunk_bias(rows, c)`` gives the ``(len(rows), chunk)`` biases of
    chunk ``c`` of those rows, zero past their degree.  Chunk ``c`` runs
    only over the rows it reaches — the reference adds zeros for the
    others, which changes no total and no crossing — in blocks of
    :data:`ROW_BLOCK` rows.  Returns each row's edge offset (int32), -1 for
    a dead end.
    """
    dev = deg.device
    n = deg.shape[0]
    order = torch.argsort(deg, descending=True)
    nchunks = max((int(deg.max()) + chunk - 1) // chunk, 1) if n else 0
    # rows reaching chunk c: a prefix of ``order``
    firsts = torch.arange(nchunks, device=dev) * chunk
    reach = (deg[None, :] > firsts[:, None]).sum(dim=1).tolist()
    blocks = [(c, order[s:min(s + ROW_BLOCK, reach[c])])
              for c in range(nchunks) for s in range(0, reach[c], ROW_BLOCK)]

    total = torch.zeros(n, dtype=torch.float32, device=dev)
    for c, rows in blocks:
        total[rows] = total[rows] + row_sum(chunk_bias(rows, c))
    target = rand * total

    cum = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.full((n,), -1, dtype=torch.int64, device=dev)
    offs = torch.arange(chunk, device=dev)
    for c, rows in blocks:
        m = c * chunk + offs < deg[rows, None]
        cw = ref.blocked_cumsum(chunk_bias(rows, c)) + cum[rows, None]
        hit = (cw > target[rows, None]) & m & (found[rows, None] < 0)
        first = hit.to(torch.uint8).argmax(dim=-1) + c * chunk
        found[rows] = torch.where((found[rows] < 0) & hit.any(dim=-1), first, found[rows])
        cum[rows] = cw[:, -1]
    live = (deg > 0) & (total > 0)
    # numerical edge: r*total == total -> take the last edge of the row
    found = torch.where((found < 0) & live, deg - 1, found)
    return torch.where(live, found, -1).to(torch.int32)


def walk_transition_chunked(
    key: np.ndarray,
    indptr: torch.Tensor,
    weights: torch.Tensor,
    cur: torch.Tensor,
    chunk: int = 512,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """One weighted ITS draw per walker over arbitrarily large rows
    (:func:`_chunked_scan` over the flat bias ``weights``).

    Returns the edge offset within each row (int32), -1 for a dead end.
    Callers pass just the walkers that need the scan.  ``rand`` overrides
    the uniforms ``uniform(key, cur.shape)``.
    """
    cur = cur.long()
    start = indptr[cur].long()
    deg = indptr[cur + 1].long() - start
    if rand is None:
        rand = uniform(key, (cur.shape[0],), device=cur.device)
    offs = torch.arange(chunk, device=cur.device)

    def chunk_bias(rows, c):
        pos = c * chunk + offs
        m = pos < deg[rows, None]
        return torch.where(m, weights[torch.where(m, start[rows, None] + pos, 0)], 0.0)

    return _chunked_scan(deg, rand, chunk, chunk_bias)


def walk_transition_chunked_window(
    key: np.ndarray,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    cur: torch.Tensor,
    bias_of,
    chunk: int = 512,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """Window-bias variant of :func:`walk_transition_chunked`: the bias of
    each ``(n, chunk)`` edge window is ``bias_of(rows, u, w, mask, eidx)``,
    the transition program's hook over candidate ids ``u`` and weights
    ``w`` (at edge positions ``eidx``) of walkers ``rows`` (indices into
    ``cur``), clipped at 0 and masked.
    Both passes evaluate the hook on identical windows.  Returns per-row
    edge offsets, -1 for dead ends.
    """
    cur = cur.long()
    start = indptr[cur].long()
    deg = indptr[cur + 1].long() - start
    if rand is None:
        rand = uniform(key, (cur.shape[0],), device=cur.device)
    offs = torch.arange(chunk, device=cur.device)

    def chunk_bias(rows, c):
        pos = c * chunk + offs
        m = pos < deg[rows, None]
        eidx = torch.where(m, start[rows, None] + pos, 0)
        u = torch.where(m, indices[eidx], -1)
        w = torch.where(m, weights[eidx], 0.0)
        return torch.where(m, torch.clamp(bias_of(rows, u, w, m, eidx), min=0.0), 0.0)

    return _chunked_scan(deg, rand, chunk, chunk_bias)


# ---------------------------------------------------------------------------
# Alias tables (Vose) and rejection sampling — host-side construction,
# identical to the reference's numpy code, so the tables are identical too.
# ---------------------------------------------------------------------------


def build_alias(indptr, bias) -> tuple[np.ndarray, np.ndarray]:
    """Per-row alias tables over a flat CSR bias array (Vose's method).

    Returns ``(prob, alias)``: ``prob`` float32 ``(E,)`` acceptance
    thresholds, ``alias`` int32 ``(E,)`` row-LOCAL redirect offsets.
    Zero-total rows get ``prob = 0`` / ``alias = -1``.  Internally float64,
    and equal to the reference's tables bit for bit: the same scaled
    weights, formed per group of equal degree as ``p = w * (d / tot)``
    (numpy's pairwise row sums are part of the bits), and the same pairing
    — each step pairs a row's lowest-index active small (``p < 1``) with its
    lowest-index active large (``p >= 1``), retires the small into
    ``alias = large`` and lowers the large by ``1 - p_small``; leftovers get
    ``p = 1``, alias self.

    The pairing is O(E).  Only the first active large ever changes, so the
    larges are consumed in index order, and those that drop below 1 join the
    smalls as a contiguous run of the row's larges; the lowest active small
    is the lower of two monotone heads, the next original small and the head
    of that run.  Three pointers per row, advanced for every unfinished row
    at once: at most ``max_degree - 1`` steps over shrinking flat arrays.
    """
    indptr = np.asarray(indptr)
    bias = np.maximum(np.asarray(bias, dtype=np.float64), 0.0)
    e = bias.shape[0]
    deg = np.diff(indptr).astype(np.int64)
    prob_out = np.zeros(e, dtype=np.float32)
    alias_out = np.full(e, -1, dtype=np.int32)

    # scaled weights of the rows with mass, per group of equal degree
    scaled = np.zeros(e)
    live = np.zeros(deg.shape[0], dtype=bool)
    order = np.argsort(deg, kind="stable")  # each group in vertex order
    ds, firsts, counts = np.unique(deg[order], return_index=True, return_counts=True)
    for d, lo, n in zip(ds.tolist(), firsts.tolist(), counts.tolist()):
        if d <= 0:
            continue
        rows = order[lo:lo + n]
        starts = indptr[:-1][rows].astype(np.int64)
        w = bias[starts[:, None] + np.arange(d)[None, :]]  # (R, d)
        tot = w.sum(axis=1)
        ok = tot > 0.0
        starts, w, tot = starts[ok], w[ok], tot[ok]
        scaled[(starts[:, None] + np.arange(d)[None, :]).ravel()] = (w * (d / tot[:, None])).ravel()
        live[rows[ok]] = True

    # the live rows' entries, row after row, in index order within each row
    ldeg = deg[live]
    first = np.cumsum(ldeg) - ldeg
    row_of = np.repeat(np.arange(ldeg.shape[0]), ldeg)
    local = np.arange(row_of.shape[0]) - first[row_of]
    pos = indptr[:-1][live].astype(np.int64)[row_of] + local
    p = scaled[pos]
    n = p.shape[0]
    small = np.nonzero(p < 1.0)[0]
    large = np.nonzero(p >= 1.0)[0]
    s_end = np.searchsorted(small, first + ldeg)
    l_end = np.searchsorted(large, first + ldeg)
    small = np.append(small, n)  # sentinels: a head at its end indexes safely
    large = np.append(large, n)
    nxt = np.searchsorted(small, first)  # next original small
    conv = np.searchsorted(large, first)  # head of the run of larges turned small
    cur = conv.copy()  # current large; large[conv:cur] is the run
    alias = local.astype(np.int32)  # leftovers alias themselves
    retired = np.zeros(n, dtype=bool)
    act = np.arange(ldeg.shape[0])
    while act.size:
        i, c, j = nxt[act], conv[act], cur[act]
        has_orig, has_conv = i < s_end[act], c < j
        step = (has_orig | has_conv) & (j < l_end[act])
        act, i, c, j = act[step], i[step], c[step], j[step]
        s_orig = np.where(has_orig[step], small[i], n)
        s_conv = np.where(has_conv[step], large[c], n)
        take_orig = s_orig < s_conv
        s = np.where(take_orig, s_orig, s_conv)
        g = large[j]
        alias[s] = local[g]
        retired[s] = True
        p[g] -= 1.0 - p[s]
        nxt[act] = i + take_orig
        conv[act] = c + ~take_orig
        cur[act] = j + (p[g] < 1.0)
    p[~retired] = 1.0
    prob_out[pos] = p.astype(np.float32)
    alias_out[pos] = alias
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
