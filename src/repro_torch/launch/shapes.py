"""The dry run's input-shape cells and ``input_specs``: the port of
``repro.launch.shapes``.

Cell policy (DESIGN.md §4):
  - train_4k    → train_step      (seq 4096,   global_batch 256)
  - prefill_32k → prefill         (seq 32768,  global_batch 32)
  - decode_32k  → serve_step      (KV cache 32768, global_batch 128)
  - long_500k   → serve_step      (KV cache 524288, global_batch 1);
                  sub-quadratic archs only (ssm/hybrid/mostly-local).
For the audio and vision architectures the frontend is a stub: a
``frontend_emb`` spec stands in for the precomputed frame or patch
embeddings, and the token span shrinks so that the whole sequence keeps the
cell's length.

A :class:`TensorSpec` is a shape and a dtype, as JAX's ``ShapeDtypeStruct``;
:func:`fake_input` makes one into a tensor of a ``FakeTensorMode``, which
allocates nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# archs allowed to run long_500k (sub-quadratic decode memory/compute)
LONG_OK = {"xlstm-350m", "recurrentgemma-9b", "gemma3-1b"}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """An input's shape and dtype, nothing allocated."""

    shape: tuple
    dtype: torch.dtype


def cell_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in LONG_OK:
        return False, "pure full-attention arch: 512k KV decode skipped (DESIGN.md §4)"
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """A :class:`TensorSpec` for every model input of this cell."""
    return cell_specs(cfg, SHAPES[shape_name])


def cell_specs(cfg: ModelConfig, cell: dict) -> dict:
    """:func:`input_specs` of a cell given by its kind, batch and sequence
    (a :data:`SHAPES` entry)."""
    b, s = cell["batch"], cell["seq"]
    f = cfg.frontend_tokens if cfg.frontend != "none" else 0
    tok = TensorSpec((b, s - f), torch.int32)
    specs: dict = {}
    if cell["kind"] in ("train", "prefill"):
        specs["tokens"] = tok
        if cell["kind"] == "train":
            specs["labels"] = TensorSpec((b, s - f), torch.int32)
        if f:
            specs["frontend_emb"] = TensorSpec((b, f, cfg.d_model), torch_dtype(cfg.dtype))
    else:  # decode
        specs["tokens"] = TensorSpec((b, 1), torch.int32)
    return specs


def fake_input(spec: TensorSpec, mode) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype on the CPU, fake under
    ``mode`` (a ``FakeTensorMode``): its values are never read."""
    with mode:
        return torch.empty(spec.shape, dtype=spec.dtype)
