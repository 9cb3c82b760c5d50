"""Decoder blocks, one function family per layer kind: ``repro.models.blocks``
for the attention kinds ("global", "local", "global_dense" without
experts).

The other kinds of ``repro`` — mixture-of-experts layers (``moe.py``: arctic,
llama4) and the recurrent cells "rglru", "mlstm" and "slstm"
(``recurrent.py``: recurrentgemma, xLSTM) — are the next slice of the port
(ROADMAP queue 1, 3a′); a block of one of them raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import ParamDef, rms_norm

ATTN_KINDS = ("global", "local", "global_dense")
RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def check_kind(cfg: ModelConfig, kind: str) -> None:
    """Raise for a layer kind the port does not run yet, or does not know."""
    if kind in RECURRENT_KINDS or (kind in ATTN_KINDS and cfg.num_experts
                                   and kind != "global_dense"):
        what = f"recurrent {kind!r} layers" if kind in RECURRENT_KINDS else "expert layers"
        raise NotImplementedError(
            f"{cfg.name}: {what} are not ported yet (ROADMAP queue 1, 3a′: "
            "MoE with the sampled router and the recurrent cells)")
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind}")


def block_defs(cfg: ModelConfig, kind: str) -> dict:
    check_kind(cfg, kind)
    d = cfg.d_model
    defs: dict = {"norm1": ParamDef((d,), init="zeros"), "attn": attn.attn_defs(cfg)}
    if cfg.d_ff:
        defs["norm2"] = ParamDef((d,), init="zeros")
        defs["ffn"] = ffn_mod.ffn_defs(cfg)
    return defs


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == "local" else 0


def block_train(
    params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss); the aux loss is the experts' and 0 here."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    x = x + attn.attention_train(params["attn"], cfg, h, positions, window=_window(cfg, kind))
    if cfg.d_ff:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_apply(params["ffn"], cfg, h2)
    return x, aux


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    check_kind(cfg, kind)
    s = min(cfg.window_size, max_len) if kind == "local" and cfg.window_size else max_len
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_decode(
    params: dict,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    cache: dict,
    cache_index: int,
) -> Tuple[torch.Tensor, dict]:
    """One token through the block; the cache is updated in place."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    y, _, _ = attn.attention_decode(params["attn"], cfg, h, cache["k"], cache["v"],
                                    cache_index, window=_window(cfg, kind))
    x = x + y
    if cfg.d_ff:
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        x = x + ffn_mod.ffn_apply(params["ffn"], cfg, h2)
    return x, cache
