"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295].

Assigned: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=("global",),
    activation="geglu",
    glu=True,
    emb_scale=True,
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
    reduce_dtype="bf16",  # §Perf gemma-7b it.1: 2x TP wire on TPU target
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    pattern=("global",),
    activation="geglu",
    glu=True,
    emb_scale=True,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
