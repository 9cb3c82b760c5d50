"""Decoder blocks, one function family per layer kind: ``repro.models.blocks``.

Kinds: "global" | "local" | "global_dense" (attention; with experts in an
MoE config, except "global_dense"), "rglru" (Griffin), "mlstm" | "slstm"
(xLSTM).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import ParamDef, const, rms_norm

ATTN_KINDS = ("global", "local", "global_dense")
STATES = {"rglru": rec.rglru_init_state, "mlstm": rec.mlstm_init_state,
          "slstm": rec.slstm_init_state}


def _experts(cfg: ModelConfig, kind: str) -> bool:
    return bool(cfg.num_experts) and kind != "global_dense"


def block_defs(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    defs: dict = {"norm1": ParamDef((d,), (None,), init="zeros")}
    if kind in ATTN_KINDS:
        defs["attn"] = attn.attn_defs(cfg)
        if _experts(cfg, kind):
            defs["norm2"] = ParamDef((d,), (None,), init="zeros")
            defs["moe"] = moe_mod.moe_defs(cfg)
            if cfg.moe_dense_ff:
                defs["dense_ffn"] = ffn_mod.ffn_defs(cfg, cfg.moe_dense_ff)
        elif cfg.d_ff:
            defs["norm2"] = ParamDef((d,), (None,), init="zeros")
            defs["ffn"] = ffn_mod.ffn_defs(cfg)
    elif kind == "rglru":
        defs["rnn"] = rec.rglru_defs(cfg)
        defs["norm2"] = ParamDef((d,), (None,), init="zeros")
        defs["ffn"] = ffn_mod.ffn_defs(cfg)
    elif kind == "mlstm":
        defs["cell"] = rec.mlstm_defs(cfg)
    elif kind == "slstm":
        defs["cell"] = rec.slstm_defs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return defs


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == "local" else 0


def _ffn(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return ffn_mod.ffn_apply(params["ffn"], cfg, rms_norm(x, params["norm2"], cfg.norm_eps))


def _mlp(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor):
    """The residual branch after attention: experts (and the dense FFN beside
    them), the FFN, or nothing.  Returns (x, aux)."""
    aux = const(x, torch.zeros((), dtype=torch.float32, device=x.device))
    if _experts(cfg, kind):
        h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
        y, aux = moe_mod.moe_apply(params["moe"], cfg, h2)
        if cfg.moe_dense_ff:
            y = y + ffn_mod.ffn_apply(params["dense_ffn"], cfg, h2)
        x = x + y
    elif cfg.d_ff:
        x = x + _ffn(params, cfg, x)
    return x, aux


def block_train(
    params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss); the aux loss is the experts' (0 without)."""
    aux = const(x, torch.zeros((), dtype=torch.float32, device=x.device))
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        x = x + attn.attention_train(params["attn"], cfg, h, positions,
                                     window=_window(cfg, kind))
        x, aux = _mlp(params, cfg, kind, x)
    elif kind == "rglru":
        x = x + rec.rglru_train(params["rnn"], cfg, h)
        x = x + _ffn(params, cfg, x)
    elif kind == "mlstm":
        x = x + rec.mlstm_train(params["cell"], cfg, h)
    elif kind == "slstm":
        x = x + rec.slstm_train(params["cell"], cfg, h)
    return x, aux


def cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Slots of an attention layer's KV cache: the window (a ring buffer)
    for a local layer, else ``max_len``."""
    return min(cfg.window_size, max_len) if kind == "local" and cfg.window_size else max_len


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    if kind in ATTN_KINDS:
        shape = (batch, cache_len(cfg, kind, max_len), cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind in STATES:
        return STATES[kind](cfg, batch, dtype, device)
    raise ValueError(f"unknown block kind {kind}")


def block_decode(
    params: dict,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    cache: dict,
    cache_index: int,
) -> Tuple[torch.Tensor, dict]:
    """One token through the block.  Returns (x, cache): an attention
    layer's cache updated in place, a recurrent layer's new state."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        y, _, _ = attn.attention_decode(params["attn"], cfg, h, cache["k"], cache["v"],
                                        cache_index, window=_window(cfg, kind))
        x, _ = _mlp(params, cfg, kind, x + y)
    elif kind == "rglru":
        y, cache = rec.rglru_decode(params["rnn"], cfg, h, cache)
        x = x + y
        x = x + _ffn(params, cfg, x)
    elif kind == "mlstm":
        y, cache = rec.mlstm_decode(params["cell"], cfg, h, cache)
        x = x + y
    elif kind == "slstm":
        y, cache = rec.slstm_decode(params["cell"], cfg, h, cache)
        x = x + y
    return x, cache
