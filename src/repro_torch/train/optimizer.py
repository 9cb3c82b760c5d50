"""Optimizers: AdamW and Adafactor, the port of ``repro.train.optimizer``.

The same math in the same order: the global-norm clip as one scale applied
inside each parameter's update, a linear warm-up (lr 0 at step 0), f32
moments, and each parameter updated in f32 and cast back to its own dtype,
with no f32 master copy (``torch.optim.AdamW`` would update a bf16
parameter in bf16).  Adafactor (β1 = 0) keeps a factored second moment
``vr``/``vc`` for matrices and clips its update by the update's RMS.

Parameters, gradients and state are dicts keyed by parameter name
(``model.named_parameters()``); the update writes the parameters and the
state in place.  On a device mesh they are DTensors: the state takes each
parameter's layout (:func:`opt_state_specs`), and the global gradient norm
is a reduction over the whole mesh.  The host computes the step's scalars (learning rate,
bias corrections) in f32, as ``repro`` traces them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import P, placements, spec_of


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_factored: int = 128
    warmup_steps: int = 100


def _clip_scale(grads, max_norm):
    """Global-norm clip as a scalar factor (a device tensor: no sync)."""
    g2 = sum(torch.sum(torch.square(g.float())) for g in grads)
    norm = torch.sqrt(g2)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _schedule(cfg: OptConfig, step: int) -> np.float32:
    warm = np.minimum(np.float32(step) / np.float32(max(cfg.warmup_steps, 1)), np.float32(1.0))
    return np.float32(cfg.lr) * warm


def _factored(p, min_dim):
    return p.ndim >= 2 and p.shape[-1] >= min_dim and p.shape[-2] >= min_dim


def state_zeros(p, drop: int | None = None):
    """f32 zeros of ``p``'s shape with dimension ``drop`` removed, on its
    device; for a DTensor ``p``, in its layout without that dimension."""
    shape = tuple(p.shape)
    if drop is not None:
        shape = shape[:drop] + shape[drop + 1:]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import zeros  # noqa: PLC0415

    spec = (list(spec_of(p.placements, p.device_mesh)) + [None] * p.ndim)[:p.ndim]
    if drop is not None:
        del spec[drop]
    return zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=placements(P(*spec), p.device_mesh))


def opt_init(cfg: OptConfig, params: dict) -> dict:
    """Zero state for ``params`` (name → tensor), f32, on their devices (in
    :func:`opt_state_specs`' layouts for DTensor parameters)."""
    if cfg.kind == "adafactor":
        def init(p):
            if _factored(p, cfg.min_dim_factored):
                return {"vr": state_zeros(p, p.ndim - 1), "vc": state_zeros(p, p.ndim - 2)}
            return {"v": state_zeros(p)}

        return {"v": {n: init(p) for n, p in params.items()}}
    return {"mu": {n: state_zeros(p) for n, p in params.items()},
            "nu": {n: state_zeros(p) for n, p in params.items()}}


@torch.no_grad()
def opt_update(cfg: OptConfig, grads: dict, state: dict, params: dict, step: int,
               groups: list | None = None):
    """One update of ``params`` and ``state`` in place from ``grads`` (all
    keyed by name).  ``groups`` lists the names that form one of ``repro``'s
    leaves (``DecoderLM.update_groups``: a stacked parameter's layers);
    Adafactor clips each group by its joint RMS, and each name is a group of
    its own by default.  Returns ``(state, grad_norm)``."""
    names = list(params)
    cscale, gnorm = _clip_scale([grads[n] for n in names], cfg.grad_clip)
    t = np.float32(step) + np.float32(1.0)
    lr = float(_schedule(cfg, step))
    g32 = {n: grads[n].float() * cscale for n in names}

    if cfg.kind == "adafactor":
        beta2 = np.float32(1.0) - t ** np.float32(-cfg.decay_rate)
        beta2, omb2 = float(beta2), float(np.float32(1.0) - beta2)
        upd = {}
        for n in names:
            g, v = g32[n], state["v"][n]
            g2 = torch.square(g) + 1e-30
            if "vr" in v:
                v["vr"].mul_(beta2).add_(omb2 * torch.mean(g2, dim=-1))
                v["vc"].mul_(beta2).add_(omb2 * torch.mean(g2, dim=-2))
                rfac = v["vr"] / torch.clamp(torch.mean(v["vr"], dim=-1, keepdim=True), min=1e-30)
                precond = torch.rsqrt(rfac[..., None] * v["vc"][..., None, :] + 1e-30)
            else:
                v["v"].mul_(beta2).add_(omb2 * g2)
                precond = torch.rsqrt(v["v"] + 1e-30)
            upd[n] = g * precond
        for group in groups or [[n] for n in names]:
            sq = sum(torch.sum(torch.square(upd[n])) for n in group)
            size = sum(upd[n].numel() for n in group)
            rms = torch.sqrt(sq / size + 1e-30)
            for n in group:
                p = params[n]
                u = upd[n] / torch.clamp(rms, min=1.0)  # Adafactor update clipping
                p32 = p.float()
                p.copy_((p32 - lr * (u + cfg.weight_decay * p32)).to(p.dtype))
        return state, gnorm

    # AdamW: b1**t and b2**t in f32, as repro's traced step computes them
    c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    for n in names:
        g, mu, nu, p = g32[n], state["mu"][n], state["nu"][n], params[n]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        p32 = p.float()
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return state, gnorm


def opt_state_specs(cfg: OptConfig, param_specs: dict, params_shape: dict) -> dict:
    """Specs of the optimizer state from the parameters' (name → spec):
    AdamW's moments take the parameter's spec; Adafactor's factored ``vr``
    and ``vc`` drop the factored dimension.  ``params_shape``: name → a
    tensor of the parameter's shape (meta) to decide the factoring."""
    if cfg.kind == "adafactor":
        def derive(spec, p):
            if _factored(p, cfg.min_dim_factored):
                parts = list(spec) + [None] * (p.ndim - len(spec))
                return {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": spec}

        return {"v": {n: derive(param_specs[n], params_shape[n]) for n in param_specs}}
    return {"mu": dict(param_specs), "nu": dict(param_specs)}
