"""Base layers: parameter definitions, norms, RoPE, causal conv, softcap.

The port of ``repro.models.layers``.  A model's parameters come from
``ParamDef`` specs, as in ``repro``: one source of truth for the shapes, the
initializers and the weight layouts (``wq`` is ``(d, heads, head_dim)`` and
applied by einsum), so that a ``repro`` parameter tree maps one to one onto
the port's modules (``models.convert``).

``repro``'s sharding helpers (``ashard``, ``set_activation_mesh``,
``model_divides``, ``rp_einsum``'s reduce dtype) constrain the layout of a
tensor over a device mesh and compute nothing; the port runs on one device
and has no counterpart for them yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` / ``param_dtype`` string."""
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | lru_lambda
    scale: float = 1.0


@torch.no_grad()
def init_param(p: torch.Tensor, d: ParamDef, gen: torch.Generator) -> None:
    """Fill ``p`` as ``repro``'s ``init_param`` draws it (the same
    distributions; the bits come from ``gen``, not from ``jax.random``)."""
    if d.init == "zeros":
        p.zero_()
    elif d.init == "ones":
        p.fill_(1.0)
    elif d.init == "lru_lambda":
        # RG-LRU: Λ init so a = sigmoid(Λ)^(8c) spreads in [0.9, 0.999]
        u = torch.empty(d.shape, dtype=torch.float32, device=p.device)
        u.uniform_(0.9, 0.999, generator=gen)
        r = u ** (1 / 8.0)
        p.copy_(torch.log(r / (1 - r)))
    else:
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        std = d.scale / np.sqrt(fan_in)
        w = torch.empty(d.shape, dtype=torch.float32, device=p.device)
        w.normal_(0.0, 1.0, generator=gen)
        p.copy_(w * std)


class ParamTree(nn.Module):
    """A nested dict of ``ParamDef`` as a module: a parameter per leaf, a
    submodule per dict, a ``ModuleList`` per list, under the defs' names.
    :meth:`tree` gives the parameters back as the nested dict the layer
    functions take."""

    def __init__(self, defs: dict, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self._defs = {}
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self._defs[name] = d
                self.register_parameter(
                    name, nn.Parameter(torch.empty(d.shape, dtype=dtype, device=device)))
            elif isinstance(d, dict):
                self.add_module(name, ParamTree(d, dtype, device))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x, dtype, device) for x in d))

    def tree(self) -> dict:
        out: dict = {name: getattr(self, name) for name in self._defs}
        for name, mod in self.named_children():
            if isinstance(mod, nn.ModuleList):
                out[name] = [m.tree() for m in mod]
            else:
                out[name] = mod.tree()
        return out

    @torch.no_grad()
    def init_from(self, gen: torch.Generator) -> None:
        """Initialize every parameter, in registration order, from ``gen``."""
        for name, d in self._defs.items():
            init_param(getattr(self, name), d, gen)
        for mod in self.children():
            for m in (mod if isinstance(mod, nn.ModuleList) else (mod,)):
                m.init_from(gen)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, a, b, preferred_element_type=float32)``: the
    operands' products accumulated and returned in f32.  bf16 operands are
    widened first, which is exact (run with TF32 off, an f32 product of two
    widened bf16 values is exact too)."""
    return torch.einsum(spec, a.float(), b.float())


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as ``repro``'s: in f32 for an f32 ``x``; for a bf16 ``x`` the
    variance accumulated in f32 and the normalization in bf16."""
    if x.dtype == torch.float32:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        xn = x * torch.rsqrt(var + eps)
        return xn * (1.0 + scale.float())
    d = x.shape[-1]
    var = einsum_f32("...d,...d->...", x, x) / d
    r = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return (x * r) * (1.0 + scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., S, H, Dh), positions: (..., S).  The
    frequencies and angles are f32, as ``repro``'s."""
    dh = x.shape[-1]
    half = dh // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), expo)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x: (B, S, C), w: (C, K).

    Returns (y, new_state) where state holds the last K-1 inputs for decode.
    """
    k = w.shape[-1]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=-2)  # (B, S+K-1, C)
    y = sum(xp[..., i : i + x.shape[-2], :] * w[:, i] for i in range(k))
    new_state = xp[..., -(k - 1) :, :] if k > 1 else pad
    return y.to(x.dtype), new_state


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: dict[str, Callable] = {
    "gelu": _gelu,
    "silu": F.silu,
    "relu": F.relu,
    "geglu": _gelu,  # gating handled by the FFN structure
    "swiglu": F.silu,
}
