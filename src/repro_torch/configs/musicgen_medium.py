"""musicgen-medium [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Assigned: 48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048.
Backbone only by assignment: the EnCodec frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (conditioning
prefix), projected and prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    pattern=("global",),
    activation="gelu",
    glu=False,
    tie_embeddings=False,
    frontend="audio",
    frontend_tokens=256,
    optimizer="adamw",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=("global",),
    activation="gelu",
    glu=False,
    tie_embeddings=False,
    frontend="audio",
    frontend_tokens=8,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
