"""Dense feed-forward blocks (GeGLU / SwiGLU / plain): ``repro.models.ffn``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ACTIVATIONS, ParamDef


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    defs = {
        "wi": ParamDef((d, f)),
        "wo": ParamDef((f, d)),
    }
    if cfg.glu:
        defs["wg"] = ParamDef((d, f))
    return defs


def ffn_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    h = torch.einsum("bsd,df->bsf", x, params["wi"])
    if cfg.glu:
        g = torch.einsum("bsd,df->bsf", x, params["wg"])
        h = act(g) * h
    else:
        h = act(h)
    return torch.einsum("bsf,fd->bsd", h, params["wo"])
