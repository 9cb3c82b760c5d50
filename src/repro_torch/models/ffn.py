"""Dense feed-forward blocks (GeGLU / SwiGLU / plain): ``repro.models.ffn``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ACTIVATIONS, ParamDef, ashard, rp_einsum


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    defs = {
        "wi": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed")),
    }
    if cfg.glu:
        defs["wg"] = ParamDef((d, f), ("embed", "mlp"))
    return defs


def ffn_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    h = ashard(rp_einsum("bsd,df->bsf", x, params["wi"], cfg.reduce_dtype), "batch", None, "model")
    if cfg.glu:
        g = ashard(rp_einsum("bsd,df->bsf", x, params["wg"], cfg.reduce_dtype),
                   "batch", None, "model")
        h = act(g) * h
    else:
        h = act(h)
    return rp_einsum("bsf,fd->bsd", h, params["wo"], cfg.reduce_dtype)
