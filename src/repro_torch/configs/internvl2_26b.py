"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Assigned: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Backbone (InternLM2-20B-class LM) only by assignment: the InternViT
frontend is a STUB — ``input_specs()`` provides precomputed patch
embeddings projected into the LM embedding space.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    pattern=("global",),
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=256,
    optimizer="adamw",
    microbatches=4,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
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
    frontend="vision",
    frontend_tokens=8,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
