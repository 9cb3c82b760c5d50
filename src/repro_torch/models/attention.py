"""GQA attention with exact-causal blocked online softmax.

The port of ``repro.models.attention``, in torch ops: a Python loop over q
chunks gives each chunk its own loop over exactly the kv chunks it can see
(the causal prefix, or the sliding window), with the online max and sum of a
flash-style softmax.  The algorithm, its masks, ``attn_softcap`` and the
bf16-scores option are ``repro``'s, so the two agree chunk by chunk.

On a device mesh (DTensor activations and weights) the layout constraints
sit where ``repro`` puts them: q, k, v and the score blocks keep their heads
on ``model`` where the heads divide it, else the q chunk; the masks and the
online softmax's accumulators are made in those layouts; a decode step
writes its KV slot on the rank that holds it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import (
    ParamDef, ashard, const, einsum_f32, idle, idle_axes, local_span, mesh_full, model_divides,
    rms_norm, rope, rp_einsum, softcap, splittable)

NEG_INF = -1e30


def pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of ``s`` not exceeding ``chunk`` (exact blocking)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.use_qk_norm:
        defs["qnorm"] = ParamDef((hd,), (None,), init="zeros")
        defs["knorm"] = ParamDef((hd,), (None,), init="zeros")
    return defs


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    heads = ("batch", None, "model", None)
    q, k, v = (ashard(rp_einsum("bsd,dhk->bshk", x, params[w], cfg.reduce_dtype), *heads)
               for w in ("wq", "wk", "wv"))
    if cfg.use_qk_norm:
        q = rms_norm(q, params["qnorm"], cfg.norm_eps)
        k = rms_norm(k, params["knorm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scores(q_blk: torch.Tensor, kc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum("bqhd,bchd->bhqc", preferred_element_type=dtype)``."""
    if dtype == torch.float32:
        return einsum_f32("bqhd,bchd->bhqc", q_blk, kc)
    return torch.einsum("bqhd,bchd->bhqc", q_blk, kc).to(dtype)


def _block_pair(
    q_blk: torch.Tensor,  # (B, Cq, H, Dh)
    k_span: torch.Tensor,  # (B, n, Ckv, H, Dh) — KV already repeated to H heads
    v_span: torch.Tensor,
    q_pos: torch.Tensor,  # (Cq,)
    kv_pos: torch.Tensor,  # (n, Ckv)
    *,
    scale: float,
    window: int,
    cap: float,
    scores_dtype: torch.dtype,
    heads_ok: bool = True,
) -> torch.Tensor:
    """Online-softmax accumulate a q block against its kv span, one kv
    chunk at a time (``repro``'s ``lax.scan`` over the span).  On a mesh
    the score blocks keep the heads on ``model`` where they divide it
    (``heads_ok``), else the q chunk: sequence-block parallelism."""
    b, cq, h, dh = q_blk.shape
    dev = q_blk.device
    if heads_ok:
        q_ax, s_ax, a_ax = ("batch", None, "model", None), ("batch", "model", None), \
            ("batch", "model", None, None)
    else:
        q_ax, s_ax, a_ax = ("batch", "model", None, None), ("batch", None, "model"), \
            ("batch", None, "model", None)
    q_blk = ashard(q_blk, *q_ax)
    neg_big = NEG_INF if scores_dtype == torch.float32 else -3e38 / 1e4
    m = mesh_full(q_blk, (b, h, cq), NEG_INF, torch.float32, *s_ax)
    l = mesh_full(q_blk, (b, h, cq), 0.0, torch.float32, *s_ax)
    acc = mesh_full(q_blk, (b, h, cq, dh), 0.0, torch.float32, *a_ax)
    scale_t = const(q_blk, torch.tensor(scale, dtype=scores_dtype, device=dev))
    neg_t = const(q_blk, torch.tensor(neg_big, dtype=scores_dtype, device=dev))
    zero_t = const(q_blk, torch.zeros((), dtype=scores_dtype, device=dev))
    for c in range(k_span.shape[1]):
        kc, vc, pos = k_span[:, c], v_span[:, c], kv_pos[c]
        s = _scores(q_blk, kc, scores_dtype) * scale_t
        s = softcap(s, cap)
        msk = pos[None, :] <= q_pos[:, None]  # causal (Cq, Ckv)
        if window > 0:
            msk = msk & (pos[None, :] > q_pos[:, None] - window)
        msk = const(q_blk, msk)
        s = torch.where(msk, s, neg_t)
        m_new = torch.maximum(m, torch.amax(s, dim=-1).float())
        p = torch.exp(s.float() - m_new[..., None]).to(scores_dtype)
        p = torch.where(msk, p, zero_t)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1, dtype=torch.float32)
        acc = acc * corr[..., None] + einsum_f32("bhqc,bchd->bhqd", p.to(kc.dtype), vc)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]  # (B, H, Cq, Dh)


def _repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """``repeat_interleave(t, g, dim=2)`` as a broadcast and a reshape
    (the same values; ops a DTensor has layouts for)."""
    b, s, kvh, dh = t.shape
    return t[:, :, :, None, :].expand(b, s, kvh, g, dh).reshape(b, s, kvh * g, dh)


def blocked_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, S, KVH, Dh)
    v: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = dh**-0.5
    cq = ckv = pick_chunk(s, cfg.attn_chunk)
    nq = s // cq
    if g > 1:  # repeat KV to full heads: q head i uses kv head i // g
        k = ashard(_repeat_heads(k, g), "batch", None, "model", None)
        v = ashard(_repeat_heads(v, g), "batch", None, "model", None)
    qg = q.reshape(b, nq, cq, h, dh)
    kc = k.reshape(b, s // ckv, ckv, h, dh)
    vc = v.reshape(b, s // ckv, ckv, h, dh)
    scores_dtype = torch.bfloat16 if cfg.attn_scores_dtype == "bf16" else torch.float32
    outs = []
    for qi in range(nq):
        q_lo = qi * cq
        ki_lo = max(0, (q_lo - window) // ckv) if window > 0 else 0
        ki_hi = (q_lo + cq - 1) // ckv  # inclusive
        n = ki_hi - ki_lo + 1
        q_pos = q_offset + q_lo + torch.arange(cq, device=q.device)
        kv_pos = q_offset + ki_lo * ckv + torch.arange(n * ckv, device=q.device).reshape(n, ckv)
        outs.append(_block_pair(
            qg[:, qi], kc[:, ki_lo:ki_hi + 1], vc[:, ki_lo:ki_hi + 1], q_pos, kv_pos,
            scale=scale, window=window, cap=cfg.attn_softcap, scores_dtype=scores_dtype,
            heads_ok=model_divides(h),
        ))
    out = torch.stack(outs, dim=1)  # (B, nq, H, Cq, Dh)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, s, h, dh)
    return out.to(q.dtype)


def attention_train(
    params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0
) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, D)."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = blocked_attention(q, k, v, cfg, window=window)
    # back in the activations' layout (sequence-block attention leaves each
    # rank a stride of every query chunk)
    return ashard(rp_einsum("bshk,hkd->bsd", out, params["wo"], cfg.reduce_dtype),
                  "batch", None, None)


def _write_slot(cache: torch.Tensor, slot: int, val: torch.Tensor) -> None:
    """``cache[:, slot] = val`` in place.  A DTensor cache (its sequence
    maybe split over ranks: split-KV) is written on its local shard, by the
    rank whose shard holds ``slot``, from ``val`` in the cache's layout."""
    if not isinstance(cache, DTensor):
        cache[:, slot] = val.to(cache.dtype)
        return
    mesh = cache.device_mesh
    row = [Replicate() if p.is_shard(1) else Shard(p.dim - 1) if p.is_shard() and p.dim > 1
           else p for p in cache.placements]
    local_val = val.to(cache.dtype).redistribute(mesh, row).to_local()
    lo, n = local_span(cache, 1)
    if lo <= slot < lo + n:
        cache.to_local()[:, slot - lo] = local_val


def attention_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache_k: torch.Tensor,  # (B, S_max, KVH, Dh)
    cache_v: torch.Tensor,
    cache_index: int,  # tokens already in the cache
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache, written in place at the token's
    slot.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache_index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    s_max = cache_k.shape[1]
    # a sliding-window layer's cache is a ring buffer: KV footprint O(window)
    slot = cache_index % s_max if window > 0 else min(cache_index, s_max - 1)
    _write_slot(cache_k, slot, k[:, 0])
    _write_slot(cache_v, slot, v[:, 0])
    kvh = cache_k.shape[2]
    g = q.shape[2] // kvh
    qh = splittable(q, 2, kvh).reshape(b, 1, kvh, g, -1)
    s = einsum_f32("bqkgd,bckd->bkgqc", qh, cache_k) * (cfg.head_dim**-0.5)
    s = softcap(s, cfg.attn_softcap)
    kv_pos = torch.arange(s_max, device=x.device)
    if window > 0:
        # ring buffer sized to the window: every written slot is in range
        msk = kv_pos < min(cache_index + 1, s_max)
    else:
        msk = kv_pos <= cache_index
    s = torch.where(const(s, msk), s, const(s, torch.tensor(NEG_INF, dtype=s.dtype,
                                                             device=x.device)))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bqkgd", p.to(cache_v.dtype), cache_v)
    out = out.reshape(b, 1, -1, cfg.head_dim)
    # the output projection runs whole on each ``model`` rank, as GSPMD
    # places it: only the FSDP axes a batch of 1 leaves idle split it
    with idle_axes(tuple(a for a in idle() if a != "model")):
        y = rp_einsum("bshk,hkd->bsd", out, params["wo"], cfg.reduce_dtype)
    return y, cache_k, cache_v
