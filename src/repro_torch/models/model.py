"""Decoder LM: parameters, train forward, chunked loss, prefill and decode.

The port of ``repro.models.model`` as an ``nn.Module``.  ``repro`` stacks the
parameters of the ``n_rep`` whole repetitions of ``cfg.pattern`` on a leading
axis and scans over them; the port keeps one module a layer, in the order of
``cfg.layer_kinds()`` (layer ``r·len(pattern) + j`` is repetition ``r``'s
``j``-th block, the tail after them), with ``repro``'s weight layouts, so
``models.convert`` maps one onto the other leaf for leaf.  ``remat`` wraps
each pattern repetition in ``torch.utils.checkpoint``, as ``repro`` wraps its
scanned superblock.

Modality frontends (musicgen audio frames, internvl2 patch embeddings) are
stubs, as in ``repro``: the caller supplies precomputed embeddings, projected
by ``frontend_proj`` and prepended to the token embeddings.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.graph.csr import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import pick_chunk
from repro_torch.models.layers import (
    ParamDef, ParamTree, einsum_f32, rms_norm, softcap, torch_dtype)


def model_defs(cfg: ModelConfig) -> dict:
    """The parameter defs, ``layers`` a list of one block's defs a layer."""
    d = cfg.d_model
    defs: dict = {
        "embed": ParamDef((cfg.vocab_size, d)),
        "final_norm": ParamDef((d,), init="zeros"),
        "layers": [blocks.block_defs(cfg, kind) for kind in cfg.layer_kinds()],
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, cfg.vocab_size))
    if cfg.frontend != "none":
        defs["frontend_proj"] = ParamDef((d, d))
    return defs


class DecoderLM(ParamTree):
    """The decoder of ``cfg`` on ``device`` (``cuda`` unless the caller asks
    for the CPU), its weights in ``cfg.param_dtype`` drawn from ``seed``.
    Parameters are named as ``repro``'s tree with the stacking undone:
    ``embed``, ``final_norm``, ``layers.<i>.attn.wq``,
    ``layers.<i>.moe.wi`` (experts first: ``(e, d, f)``),
    ``layers.<i>.rnn.lam``, ``layers.<i>.cell.r``, ``head``, ..."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        super().__init__(model_defs(cfg), torch_dtype(cfg.param_dtype), dev)
        self.cfg = cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.init_from(gen)

    def forward(self, tokens, frontend_emb=None):
        return forward(self, tokens, frontend_emb)

    def update_groups(self) -> list:
        """Parameter names grouped as ``repro``'s leaves hold them: the same
        parameter of one pattern position across the ``n_rep`` repetitions
        is one stacked leaf there, every other parameter a leaf of its own.
        Adafactor clips its update by the RMS of a whole leaf."""
        cfg, per = self.cfg, len(self.cfg.pattern)
        stacked = cfg.n_rep * per
        groups: dict = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers" and int(parts[1]) < stacked:
                key = ("stack", int(parts[1]) % per, ".".join(parts[2:]))
            else:
                key = (name,)
            groups.setdefault(key, []).append(name)
        return list(groups.values())


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, frontend_emb) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))
    if cfg.emb_scale:
        x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=torch.float32,
                                        device=x.device)).to(x.dtype)
    if cfg.frontend != "none" and frontend_emb is not None:
        fe = torch.einsum("bsd,de->bse", frontend_emb.to(device=x.device, dtype=x.dtype),
                          params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    return x


def forward_hidden(
    model: DecoderLM,
    tokens: torch.Tensor,  # (B, S)
    frontend_emb: Optional[torch.Tensor] = None,  # (B, F, D) for audio/vlm stubs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder trunk. Returns (final-normed hidden (B, S_total, D), aux)."""
    cfg = model.cfg
    params = model.tree()
    x = _embed(params, cfg, tokens, frontend_emb)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kinds = cfg.layer_kinds()
    per = len(cfg.pattern)

    def superblock(x, first):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(first, first + per):
            x, a = blocks.block_train(params["layers"][i], cfg, kinds[i], x, positions)
            aux = aux + a
        return x, aux

    # "dots" keeps the matmul outputs in repro; here it recomputes them like
    # "full" (the difference is memory, not values)
    remat = cfg.remat in ("full", "dots") and torch.is_grad_enabled()
    for r in range(cfg.n_rep):
        if remat:
            x, a = checkpoint(superblock, x, r * per, use_reentrant=False)
        else:
            x, a = superblock(x, r * per)
        aux_total = aux_total + a
    for i in range(cfg.n_rep * per, cfg.num_layers):
        x, a = blocks.block_train(params["layers"][i], cfg, kinds[i], x, positions)
        aux_total = aux_total + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["head"] if not cfg.tie_embeddings else params["embed"].T


def logits_of(model: DecoderLM, x: torch.Tensor) -> torch.Tensor:
    """The head and the logit softcap over hidden states ``x`` (B, S, D)."""
    head = _head(model.tree(), model.cfg)
    logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    return softcap(logits, model.cfg.logit_softcap)


def forward(
    model: DecoderLM,
    tokens: torch.Tensor,
    frontend_emb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with logits (prefill/decode-scale shapes only —
    training uses loss_fn's chunked CE so (B,S,V) never materializes)."""
    x, aux_total = forward_hidden(model, tokens, frontend_emb)
    return logits_of(model, x), aux_total


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> dict:
    """Decode cache: one entry a layer (an attention layer's ``{"k", "v"}``,
    a ring buffer of the window for a local layer; a recurrent layer's
    state) and ``index``, the tokens already in it."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return {
        "layers": [blocks.block_cache_init(cfg, kind, batch, max_len, dtype, dev)
                   for kind in cfg.layer_kinds()],
        "index": 0,
    }


def decode_step(model: DecoderLM, tokens: torch.Tensor, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, 1, V), cache),
    the cache updated in place: the attention layers' buffers written, the
    recurrent layers' new states stored in ``cache["layers"]``."""
    cfg = model.cfg
    params = model.tree()
    x = _embed(params, cfg, tokens, None)
    index = cache["index"]
    for i, kind in enumerate(cfg.layer_kinds()):
        x, cache["layers"][i] = blocks.block_decode(params["layers"][i], cfg, kind, x,
                                                    cache["layers"][i], index)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["index"] = index + 1
    return logits_of(model, x), cache


def _chunk_nll(xc, lc, head, cap):
    logits = softcap(einsum_f32("bcd,dv->bcv", xc, head), cap)
    mask = lc >= 0
    safe = torch.clamp(lc, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask, dtype=torch.int32)


def loss_fn(
    model: DecoderLM,
    tokens: torch.Tensor,  # (B, S) inputs
    labels: torch.Tensor,  # (B, S) targets (-100 = masked)
    frontend_emb: Optional[torch.Tensor] = None,
    aux_weight: float = 0.01,
    loss_chunk: int | None = None,
) -> torch.Tensor:
    """Cross entropy with *chunked* logits: the (B, S, V) tensor never
    materializes.  Each sequence chunk computes logits → logsumexp → NLL
    in f32 under ``checkpoint``, so its backward recomputes the chunk's
    logits instead of keeping them (``repro`` remats the chunk the same
    way, whatever ``cfg.remat`` says)."""
    cfg = model.cfg
    x, aux = forward_hidden(model, tokens, frontend_emb)
    if cfg.frontend != "none" and frontend_emb is not None:
        x = x[:, frontend_emb.shape[1]:]
    head = _head(model.tree(), cfg).to(x.dtype)
    labels = labels.to(x.device)
    b, s, _ = x.shape
    c = pick_chunk(s, loss_chunk or cfg.loss_chunk)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for lo in range(0, s, c):
        xc, lc = x[:, lo:lo + c], labels[:, lo:lo + c]
        if torch.is_grad_enabled():
            n, k = checkpoint(_chunk_nll, xc, lc, head, cfg.logit_softcap, use_reentrant=False)
        else:
            n, k = _chunk_nll(xc, lc, head, cfg.logit_softcap)
        nll, cnt = nll + n, cnt + k
    return nll / torch.clamp(cnt, min=1) + aux_weight * aux
