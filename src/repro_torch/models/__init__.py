"""Decoder LM zoo: the port of ``repro.models`` (attention with and without
experts, RG-LRU, mLSTM and sLSTM layers: all ten architectures)."""
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
