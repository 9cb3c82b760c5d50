"""Decoder LM zoo: the port of ``repro.models`` for the dense architectures
(layer kinds "global", "local" and "global_dense" without experts)."""
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    forward_hidden,
    init_cache,
    loss_fn,
    model_defs,
)

__all__ = [
    "DecoderLM",
    "decode_step",
    "forward",
    "forward_hidden",
    "init_cache",
    "loss_fn",
    "model_defs",
]
