"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173].

Assigned: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
Plain GELU MLP (no GLU), sliding-window-free full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    pattern=("global",),
    activation="gelu",
    glu=False,
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("global",),
    activation="gelu",
    glu=False,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
