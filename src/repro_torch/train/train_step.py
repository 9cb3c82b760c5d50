"""Train, prefill and serve steps on one device: ``repro.train.train_step``.

``make_train_step`` builds the ``(model, opt_state, step, batch) ->
(opt_state, step, metrics)`` step: the loss's gradient by autograd, summed in
f32 over ``cfg.microbatches`` slices of the batch, then ``opt_update``;
``make_prefill`` the last-position logits of a full forward;
``make_serve_step`` the one-token decode with the cache updated in place.
Each takes ``device`` (``cuda`` unless the caller asks for the CPU) and moves
the batch there; the model and its state must already live there.

``repro``'s mesh placements (parameter, cache and batch shardings), the
activation rules and the ``compressed`` cross-pod gradient mode wait for the
port's ``distributed`` package (ROADMAP queue 1, 3b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graph.csr import resolve_device
from repro_torch.models import blocks
from repro_torch.models import model as m
from repro_torch.train import optimizer as opt


def _on(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _device(device) -> torch.device:
    """The step's device; a bare ``cuda`` is pinned to the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_model(model: m.DecoderLM, cfg: ModelConfig, dev: torch.device) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is {model.cfg.name}")
    if model.embed.device != dev:
        raise ValueError(f"step runs on {dev}, model is on {model.embed.device}")


def make_train_step(cfg: ModelConfig, ocfg: opt.OptConfig, *, device="cuda"):
    """Returns ``step_fn(model, opt_state, step, batch) -> (opt_state, step + 1,
    metrics)``: the model's parameters and ``opt_state`` are updated in place;
    ``metrics`` holds ``loss``, ``grad_norm`` (0-d device tensors) and
    ``step``.  ``batch`` = ``{tokens, labels[, frontend_emb]}``."""
    dev = _device(device)

    def grads_of(model, params, batch):
        loss = m.loss_fn(model, batch["tokens"], batch["labels"], batch.get("frontend_emb"))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def step_fn(model, opt_state, step: int, batch: dict):
        _check_model(model, cfg, dev)
        batch = _on(batch, dev)
        params = dict(model.named_parameters())
        mb = cfg.microbatches
        if mb > 1:
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"batch {b} does not split into {mb} microbatches "
                                 f"({cfg.name})")
            per = b // mb
            # gradient accumulation in f32: activations scale 1/mb
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                loss, grads = grads_of(model, params, part)
                for n, g in grads.items():
                    gsum[n] += g
                lsum = lsum + loss
            grads = {n: g / mb for n, g in gsum.items()}
            loss = lsum / mb
        else:
            loss, grads = grads_of(model, params, batch)
        opt_state, gnorm = opt.opt_update(ocfg, grads, opt_state, params, step,
                                          model.update_groups())
        return opt_state, step + 1, {"loss": loss, "grad_norm": gnorm, "step": step + 1}

    return step_fn


def make_prefill(cfg: ModelConfig, *, device="cuda"):
    """Prefill: ``prefill(model, batch) -> (B, V)``, the last position's
    logits of a full forward.  Only that position goes through the head, so
    the (B, S, V) logits never materialize."""
    dev = _device(device)

    @torch.no_grad()
    def prefill(model, batch):
        _check_model(model, cfg, dev)
        batch = _on(batch, dev)
        x, _ = m.forward_hidden(model, batch["tokens"], batch.get("frontend_emb"))
        return m.logits_of(model, x[:, -1:])[:, 0]

    return prefill


def make_serve_step(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """One-token decode: ``serve(model, cache, tokens) -> (logits (B, 1, V),
    cache)`` on a cache from ``models.init_cache(cfg, batch, max_len)``,
    updated in place."""
    dev = _device(device)

    @torch.no_grad()
    def serve(model, cache, tokens):
        _check_model(model, cfg, dev)
        tokens = torch.as_tensor(tokens).to(dev)
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"serve step takes tokens ({batch}, 1), got {tuple(tokens.shape)}")
        for kind, c in zip(cfg.layer_kinds(), cache["layers"]):
            rows = next(iter(c.values())).shape[0]
            if rows != batch or ("k" in c and c["k"].shape[1]
                                 != blocks.cache_len(cfg, kind, max_len)):
                raise ValueError(f"serve step takes a cache of {batch} × {max_len} tokens")
        return m.decode_step(model, tokens, cache)

    return serve
