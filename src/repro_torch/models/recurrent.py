"""Recurrent blocks: RG-LRU (Griffin / RecurrentGemma) and xLSTM (mLSTM,
sLSTM), the port of ``repro.models.recurrent``.

The time-parallel forms are ``repro``'s:
  - RG-LRU: a log-depth scan over the ``(a, b)`` affine pairs.  ``repro``
    runs ``jax.lax.associative_scan``; :func:`affine_scan` is the same
    recursion (pairs combined, the half-length scan, the even positions
    filled in) in torch ops, so the products associate as there.
  - mLSTM: the blocked quadratic form with the cumulative log-forget bias
    and an online max stabilizer, blocked as attention (``pick_chunk``).
  - sLSTM: sequential by construction, a Python loop over time steps.
    ``repro``'s ``SLSTM_TIME_CHUNK`` unrolls its ``lax.scan`` to cut XLA's
    all-reduces and changes no value, so the port has no counterpart.

Each block also has a one-token decode step carrying O(1) state.  The gates
and the recurrent states are f32 whatever the activations' dtype, as in
``repro``.  Without a mesh ``reduce_dtype`` changes values in one place
only, the sLSTM's recurrent product, where ``"bf16"`` casts the state and
``r`` to bf16 first; on a mesh it is also the dtype in which ``rp_einsum``
sums a product's partial sums.  On a mesh the RG-LRU and mLSTM projections
keep their width on ``model`` (``ashard``), the mLSTM's quadratic form its
heads or, where they do not divide the axis, runs as a region on each
rank's batch and q-chunk rows (:func:`_mlstm_local`), as ``repro`` shards
its q chunk; the sLSTM's recurrence splits its head width over ``model``,
and in the train step its down projection its output where ``model`` does
not divide the width; the cumulative log-forget bias runs on each rank's
whole time axis.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import pick_chunk
from repro_torch.models.layers import (
    ParamDef, _gelu, activation_placements, ashard, causal_conv1d, const, einsum_f32, from_local,
    grad_in, local_rows, mesh_full, model_divides, rp_einsum, shard_span, splittable)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------


def rglru_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.rnn_width or d
    k = cfg.conv1d_width
    return {
        "wx": ParamDef((d, w), ("embed", "rnn")),
        "wgate": ParamDef((d, w), ("embed", "rnn")),
        "conv_w": ParamDef((w, k), ("rnn", None), scale=0.5),
        "wa": ParamDef((w, w), ("rnn", None)),
        "ba": ParamDef((w,), (None,), init="zeros"),
        "wi": ParamDef((w, w), ("rnn", None)),
        "bi": ParamDef((w,), (None,), init="zeros"),
        "lam": ParamDef((w,), (None,), init="lru_lambda"),
        "wout": ParamDef((w, d), ("rnn", "embed")),
    }


def _rglru_gates(params, cfg: ModelConfig, u):
    c = 8.0
    r = torch.sigmoid(rp_einsum("bsw,wv->bsv", u, params["wa"], cfg.reduce_dtype) + params["ba"])
    i = torch.sigmoid(rp_einsum("bsw,wv->bsv", u, params["wi"], cfg.reduce_dtype) + params["bi"])
    log_a = -c * F.softplus(params["lam"]).float() * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i.float() * u.float())
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at positions 0, 2, ... and ``odd`` at 1, 3, ... of axis 1
    (``even`` as long as ``odd`` or one longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], dim=1)


def affine_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the affine maps ``h -> a·h + b``
    composed in time order: returns ``(A, H)`` with ``H[t] = a[t]·H[t-1] +
    b[t]`` from ``H[-1] = 0``.  The recursion of ``jax.lax.associative_scan``
    (log2 S levels, O(S) work): combine adjacent pairs, scan the half-length
    sequence, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = affine_scan(a1 * a2, a2 * b1 + b2)
    pa, pb = (odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0 else (odd_a, odd_b)
    ea, eb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * ea], dim=1)
    even_b = torch.cat([b[:, :1], ea * pb + eb], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_train(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    gate = _gelu(ashard(torch.einsum("bsd,dw->bsw", x, params["wgate"]), "batch", None, "model"))
    u = ashard(torch.einsum("bsd,dw->bsw", x, params["wx"]), "batch", None, "model")
    u, _ = causal_conv1d(u, params["conv_w"])
    a, b = _rglru_gates(params, cfg, u)
    _, h = affine_scan(a, b)
    h = h.to(x.dtype)
    return rp_einsum("bsw,wd->bsd", gate * h, params["wout"], cfg.reduce_dtype)


def rglru_decode(
    params: dict, cfg: ModelConfig, x: torch.Tensor, state: dict
) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D); state: {'h': (B, W) f32, 'conv': (B, K-1, W)}."""
    rd = cfg.reduce_dtype
    gate = _gelu(rp_einsum("bsd,dw->bsw", x, params["wgate"], rd))
    u = rp_einsum("bsd,dw->bsw", x, params["wx"], rd)
    u, conv_state = causal_conv1d(u, params["conv_w"], state["conv"])
    a, b = _rglru_gates(params, cfg, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = gate * h[:, None].to(x.dtype)
    return rp_einsum("bsw,wd->bsd", y, params["wout"], rd), {"h": h, "conv": conv_state}


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    p = int(d * cfg.mlstm_proj_factor)
    k = cfg.conv1d_width
    return {
        "wup": ParamDef((d, p), ("embed", "mlp")),
        "wz": ParamDef((d, p), ("embed", "mlp")),
        "conv_w": ParamDef((p, k), ("mlp", None), scale=0.5),
        "wq": ParamDef((p, p), ("mlp", None)),
        "wk": ParamDef((p, p), ("mlp", None)),
        "wv": ParamDef((p, p), ("mlp", None)),
        "wif": ParamDef((p, 2 * cfg.num_heads), ("mlp", None), scale=0.1),
        "bif": ParamDef((2 * cfg.num_heads,), (None,), init="zeros"),
        "skip": ParamDef((p,), (None,), init="ones"),
        "wdown": ParamDef((p, d), ("mlp", "embed")),
    }


def _mlstm_qkv_gates(params, cfg, x):
    """q, k, v (B, S, H, hd), the input and forget gates' pre-activations
    (B, S, H) f32, the output gate ``z`` and the conv branch ``uc``."""
    h = cfg.num_heads
    u = ashard(torch.einsum("bsd,dp->bsp", x, params["wup"]), "batch", None, "model")
    z = ashard(torch.einsum("bsd,dp->bsp", x, params["wz"]), "batch", None, "model")
    uc, _ = causal_conv1d(u, params["conv_w"])
    uc = F.silu(uc)
    q = torch.einsum("bsp,pr->bsr", uc, params["wq"])
    k = torch.einsum("bsp,pr->bsr", uc, params["wk"])
    v = torch.einsum("bsp,pr->bsr", u, params["wv"])
    gif = torch.einsum("bsp,pg->bsg", uc, params["wif"]) + params["bif"]
    ig, fg = gif[..., :h].float(), gif[..., h:].float()
    b, s, p = q.shape
    shp = (b, s, h, p // h)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp), ig, fg, z, uc


def _mlstm_rows(q_blk, fq, q_idx, kg, vg, fk, ik, state, scale):
    """One q block's rows of the blocked mLSTM against the key chunks
    ``0 .. len(kg) - 1``: ``q_blk`` (B, R, H, hd) at positions ``q_idx``, its
    F ``fq`` (B, H, R); each key chunk ``kg[j]``, ``vg[j]`` (B, C, H, hd), its
    F and input gate ``fk[j]``, ``ik[j]`` (B, H, C); ``state`` the online
    (max, numerator, denominator) to start from.  Returns (B, R, H, hd)."""
    m, num, den = state
    c = kg[0].shape[1]
    for ki, (kc, vc) in enumerate(zip(kg, vg)):
        # decay bias D_ij = F_i - F_j + i_j  (j <= i)
        dmat = fq[..., :, None] - fk[ki][..., None, :] + ik[ki][..., None, :]
        k_idx = ki * c + torch.arange(c, device=q_idx.device)
        msk = const(q_blk, k_idx[None, :] <= q_idx[:, None])
        dmat = torch.where(msk, dmat, const(q_blk, torch.tensor(NEG_INF, device=q_idx.device)))
        m_new = torch.maximum(m, torch.amax(dmat, dim=-1))
        w = torch.exp(dmat - m_new[..., None])
        sw = einsum_f32("bqhd,bchd->bhqc", q_blk, kc) * scale * w
        corr = torch.exp(m - m_new)
        num = num * corr[..., None] + einsum_f32("bhqc,bchd->bhqd", sw.to(vc.dtype), vc)
        den = den * corr + torch.sum(sw, dim=-1)
        m = m_new
    hout = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]
    return hout.transpose(1, 2)


def _mlstm_form(q, k, v, big_f, ig, c: int, lo: int = 0, rows: int | None = None
                ) -> torch.Tensor:
    """The blocked quadratic form: q, k, v (B, S, H, hd), F and the input
    gate (B, S, H), chunks of ``c``; of each q chunk only the ``rows`` rows
    from ``lo`` (all by default).  On a mesh whose ``model`` axis divides
    the heads, each q block and its state keep their heads on ``model``
    (``ashard`` and ``mesh_full`` are identities on plain and local
    tensors).  Returns (B, n, rows, H, hd) f32."""
    b, s, h, hd = q.shape
    n, rows = s // c, c if rows is None else rows
    kg, vg = (t.reshape(b, n, c, h, hd) for t in (k, v))
    qg = q.reshape(b, n, c, h, hd)
    # (B, n, H, C): each chunk's F and input gate, heads before time
    fg_ = big_f.reshape(b, n, c, h).transpose(2, 3)
    ig_ = ig.reshape(b, n, c, h).transpose(2, 3)
    ks, vs, fs, gs = ([t[:, j] for j in range(n)] for t in (kg, vg, fg_, ig_))
    part = slice(lo, lo + rows) if rows < c else slice(None)
    heads = ("batch", "model", None)
    outs = []
    for qi in range(n):
        q_blk = ashard(qg[:, qi, part], "batch", None, "model", None)
        state = (mesh_full(q_blk, (b, h, rows), NEG_INF, torch.float32, *heads),
                 mesh_full(q_blk, (b, h, rows, hd), 0.0, torch.float32, *heads, None),
                 mesh_full(q_blk, (b, h, rows), 0.0, torch.float32, *heads))
        q_idx = qi * c + lo + torch.arange(rows, device=q.device)
        outs.append(_mlstm_rows(q_blk, fs[qi][..., part], q_idx, ks[:qi + 1], vs[:qi + 1],
                                fs[:qi + 1], gs[:qi + 1], state, hd**-0.5))
    return torch.stack(outs, dim=1)


def _mlstm_local(q, k, v, big_f, ig, c: int) -> torch.Tensor:
    """:func:`_mlstm_form` on a mesh whose ``model`` axis does not divide
    the heads, as a region on each rank's local tensors: the heads whole,
    each rank its batch rows and its share of every q chunk's rows (as
    ``repro`` shards the q-chunk dim), the keys of all earlier chunks
    gathered.  The inputs' gradients are partial over the ranks that split
    the rows; the output (B, S, H·hd) is in the layout of the projections
    beside it, the feature dim on ``model``."""
    mesh = q.device_mesh
    b, s, h, hd = q.shape
    n = s // c
    lay = activation_placements((b, n, c, h * hd), "batch", None, "model", None)
    batch = [i for i, p in enumerate(lay) if p.is_shard(0)]
    split = [i for i, p in enumerate(lay) if p.is_shard(2)]
    want = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    grad = [Shard(0) if i in batch else Partial() if i in split else Replicate()
            for i in range(mesh.ndim)]

    def local(t):
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        # the partial gradients reduced here, not carried into the
        # projections' backward
        return grad_in(t, want).to_local(grad_placements=grad)

    lo, rows = shard_span(mesh, lay, 2, c)
    out = _mlstm_form(*(local(t) for t in (q, k, v, big_f, ig)), c, lo, rows)
    out = from_local(out.reshape(out.shape[0], n, rows, h * hd), mesh, lay, (b, n, c, h * hd))
    feat = activation_placements((b, n, c, h * hd), "batch", None, None, "model")
    return out.redistribute(mesh, feat).reshape(b, s, h * hd)


def mlstm_train(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Blocked parallel mLSTM. x: (B, S, D)."""
    q, k, v, ig, fg, z, uc = _mlstm_qkv_gates(params, cfg, x)
    b, s, h, hd = q.shape
    # F_t = sum_{tau<=t} log f, along each rank's whole time axis
    big_f = local_rows(lambda t: torch.cumsum(F.logsigmoid(t), dim=1), fg)
    c = pick_chunk(s, cfg.attn_chunk)
    if isinstance(q, DTensor) and not model_divides(h):
        # xLSTM head counts (4) rarely divide the model axis
        y = _mlstm_local(q, k, v, big_f, ig, c)
    else:
        y = _mlstm_form(q, k, v, big_f, ig, c).reshape(b, s, h * hd)
    y = y.to(x.dtype) + params["skip"] * uc
    y = y * F.silu(z)
    return rp_einsum("bsp,pd->bsd", y, params["wdown"], cfg.reduce_dtype)


def mlstm_decode(params, cfg: ModelConfig, x: torch.Tensor, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """x: (B,1,D); state: {'C': (B,H,hd,hd), 'n': (B,H,hd), 'm': (B,H), 'conv': ...}."""
    hn, rd = cfg.num_heads, cfg.reduce_dtype
    u = rp_einsum("bsd,dp->bsp", x, params["wup"], rd)
    z = rp_einsum("bsd,dp->bsp", x, params["wz"], rd)
    uc, conv_state = causal_conv1d(u, params["conv_w"], state["conv"])
    uc = F.silu(uc)
    q = rp_einsum("bsp,pr->bsr", uc, params["wq"], rd)
    k = rp_einsum("bsp,pr->bsr", uc, params["wk"], rd)
    v = rp_einsum("bsp,pr->bsr", u, params["wv"], rd)
    gif = rp_einsum("bsp,pg->bsg", uc, params["wif"], rd) + params["bif"]
    ig, fg = gif[..., :hn].float(), gif[..., hn:].float()
    b = x.shape[0]
    hd = q.shape[-1] // hn
    q, k, v = (t.reshape(b, hn, hd) for t in (q[:, 0], k[:, 0], v[:, 0]))
    scale = hd**-0.5
    logf = local_rows(F.logsigmoid, fg[:, 0])  # (B,H)
    m_new = torch.maximum(logf + state["m"], ig[:, 0])
    f_s = torch.exp(logf + state["m"] - m_new)
    i_s = torch.exp(ig[:, 0] - m_new)
    kf = k.float() * scale
    cmat = (f_s[..., None, None] * state["C"]
            + i_s[..., None, None] * v.float()[..., :, None] * kf[..., None, :])
    nvec = f_s[..., None] * state["n"] + i_s[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", cmat, qf)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", nvec, qf)), torch.exp(-m_new))
    hout = (num / den[..., None]).reshape(b, 1, hn * hd).to(x.dtype)
    y = hout + params["skip"] * uc
    y = y * F.silu(z)
    return rp_einsum("bsp,pd->bsd", y, params["wdown"], rd), {
        "C": cmat, "n": nvec, "m": m_new, "conv": conv_state,
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    p = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.num_heads
    hd = p // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.full((batch, h), -1e9, **f32),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, p), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block) — sequential by construction
# ---------------------------------------------------------------------------


def slstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    up = int(d * cfg.slstm_proj_factor)
    return {
        "wx": ParamDef((d, 4 * d), ("embed", "mlp"), scale=0.5),
        "bx": ParamDef((4 * d,), (None,), init="zeros"),
        "r": ParamDef((h, hd, 4 * hd), (None, None, None), scale=0.5),
        "wup": ParamDef((d, up), ("embed", "mlp")),
        "wgate": ParamDef((d, up), ("embed", "mlp")),
        "wdown": ParamDef((up, d), ("mlp", "embed")),
    }


def _rec_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype of the recurrent product: ``repro`` casts the f32 state and
    ``r`` to bf16 under ``reduce_dtype="bf16"``, which changes values; else
    the product is the f32 state's (``r`` widened exactly)."""
    return torch.bfloat16 if cfg.reduce_dtype == "bf16" else torch.float32


def _slstm_cell(cfg, r, xt, state):
    """One sLSTM step. xt: (B, 4D) pre-activations; ``r`` already in
    :func:`_rec_dtype`; the state is f32."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    b = xt.shape[0]
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    # recurrent contribution (block-diagonal per head)
    rec = rp_einsum("bhk,hkg->bhg", splittable(h, 1, nh).reshape(b, nh, hd).to(r.dtype), r,
                    cfg.reduce_dtype)
    z, i, f, o = torch.split(xt.float() + rec.reshape(b, 4 * cfg.d_model).float(),
                             cfg.d_model, dim=-1)
    m_new = torch.maximum(f + m, i)  # exponential i, sigmoid-exp f stabilizer
    i_s = torch.exp(i - m_new)
    f_s = torch.exp(f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(z)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(o) * (c_new / torch.clamp(n_new, min=1e-6))
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_mlp(params, cfg: ModelConfig, hs: torch.Tensor) -> torch.Tensor:
    """The post up / gate / down MLP (xLSTM pf 4/3)."""
    rd = cfg.reduce_dtype
    up = rp_einsum("bsd,du->bsu", hs, params["wup"], rd)
    gate = _gelu(rp_einsum("bsd,du->bsu", hs, params["wgate"], rd))
    wdown = params["wdown"]
    if torch.is_grad_enabled() and not model_divides(wdown.shape[0]):
        # a width ``model`` does not divide (1,365 of 16): the train step
        # splits the down projection's output over ``model``; prefill and
        # decode run it whole on each rank, as GSPMD places them
        wdown = ashard(wdown, None, "model")
    return rp_einsum("bsu,ud->bsd", up * gate, wdown, rd)


def _slstm_r(params, cfg: ModelConfig) -> torch.Tensor:
    """``r`` in :func:`_rec_dtype`, on a mesh its head width split over
    ``model`` (the recurrence's contraction, as GSPMD places it)."""
    return ashard(params["r"].to(_rec_dtype(cfg)), None, "model", None)


def slstm_train(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    xa = rp_einsum("bsd,dg->bsg", x, params["wx"], cfg.reduce_dtype) + params["bx"]
    # the state in the activations' batch layout on a mesh
    state = {k: mesh_full(x, (b, d), v, torch.float32, "batch", None)
             for k, v in SLSTM_INIT.items()}
    r = _slstm_r(params, cfg)
    hs = []
    for t in range(s):
        state = _slstm_cell(cfg, r, xa[:, t], state)
        hs.append(state["h"])
    return _slstm_mlp(params, cfg, torch.stack(hs, dim=1).to(x.dtype))


def slstm_decode(params, cfg: ModelConfig, x: torch.Tensor, state: dict
                 ) -> Tuple[torch.Tensor, dict]:
    xa = rp_einsum("bsd,dg->bsg", x, params["wx"], cfg.reduce_dtype) + params["bx"]
    new = _slstm_cell(cfg, _slstm_r(params, cfg), xa[:, 0], state)
    return _slstm_mlp(params, cfg, new["h"][:, None].to(x.dtype)), new


#: the sLSTM's initial state, each entry filled with its value
SLSTM_INIT = {"h": 0.0, "c": 0.0, "n": 1e-6, "m": 0.0}


def slstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {k: torch.full((batch, cfg.d_model), v, dtype=torch.float32, device=device)
            for k, v in SLSTM_INIT.items()}
