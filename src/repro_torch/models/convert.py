"""Carry weights between ``repro``'s parameter tree and the port's modules.

``repro`` stacks the ``n_rep`` repetitions of ``cfg.pattern`` on a leading
axis (``params["blocks"][j]`` holds pattern position ``j`` of every
repetition) and keeps the remainder layers in ``params["tail"]``; the port
has one module a layer.  Both sides take plain numpy trees, so nothing here
imports JAX: take ``repro``'s tree to numpy with ``np.asarray`` per leaf
(bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays and are read by their
16-bit words).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def _to_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype)


def _walk(tree, prefix: str):
    """``(name, leaf)`` of a nested dict, names joined by dots."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _walk(v, name + ".")
        else:
            yield name, v


def params_from_jax(tree: dict, cfg: ModelConfig) -> dict:
    """A state dict for ``DecoderLM(cfg)`` from ``repro``'s parameter tree
    (numpy leaves), in ``cfg.param_dtype``: ``blocks[j]``'s slice ``r`` is
    layer ``r·len(pattern) + j``, ``tail[i]`` layer ``n_rep·len(pattern) + i``."""
    dtype = torch_dtype(cfg.param_dtype)
    per = len(cfg.pattern)
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            for j, blk in enumerate(v):
                for name, leaf in _walk(blk, ""):
                    leaf = np.asarray(leaf)
                    for r in range(cfg.n_rep):
                        out[f"layers.{r * per + j}.{name}"] = _to_tensor(leaf[r], dtype)
        elif k == "tail":
            for i, blk in enumerate(v):
                for name, leaf in _walk(blk, ""):
                    out[f"layers.{cfg.n_rep * per + i}.{name}"] = _to_tensor(leaf, dtype)
        else:
            out[k] = _to_tensor(v, dtype)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16 without ml_dtypes: widen (exactly) to f32
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def params_to_numpy(state: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: ``repro``'s tree layout, with
    numpy leaves (bf16 widened to f32, which is exact), from a state dict
    (``model.state_dict()``)."""
    per = len(cfg.pattern)
    stacked = cfg.n_rep * per
    tree: dict = {}
    blocks: list = [dict() for _ in range(per)] if cfg.n_rep else []
    tail: list = [dict() for _ in range(cfg.num_layers - stacked)]
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] != "layers":
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _numpy(t)
            continue
        i, rest = int(parts[1]), parts[2:]
        if i < stacked:
            node = blocks[i % per]
            key = ("rep", i // per)
        else:
            node = tail[i - stacked]
            key = None
        for p in rest[:-1]:
            node = node.setdefault(p, {})
        if key is None:
            node[rest[-1]] = _numpy(t)
        else:
            node.setdefault(rest[-1], {})[key[1]] = _numpy(t)
    for blk in blocks:
        _stack(blk, cfg.n_rep)
    if blocks:
        tree["blocks"] = blocks
    if tail:
        tree["tail"] = tail
    return tree


def _stack(node: dict, n_rep: int) -> None:
    for k, v in node.items():
        if isinstance(v, dict) and set(v) == set(range(n_rep)):
            node[k] = np.stack([v[r] for r in range(n_rep)])
        else:
            _stack(v, n_rep)
