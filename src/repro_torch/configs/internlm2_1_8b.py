"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297].

Assigned: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
SwiGLU, RoPE, untied output head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    pattern=("global",),
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    optimizer="adamw",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("global",),
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
