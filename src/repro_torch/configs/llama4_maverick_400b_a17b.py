"""llama4-maverick-400b-a17b [moe] — MoE top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128e top-1.  Maverick interleaves MoE with dense layers (1:1) and adds
a shared-expert FFN (d_ff) in parallel with the routed top-1 expert —
that is what lands total params at ~400B with 17B active.  Adafactor.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=("global_dense", "global"),
    num_experts=128,
    num_experts_per_tok=1,
    moe_dense_ff=8192,  # shared expert
    capacity_factor=1.25,
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    optimizer="adafactor",
    microbatches=4,
    reduce_dtype="bf16",
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("global_dense", "global"),
    num_experts=4,
    num_experts_per_tok=1,
    moe_dense_ff=128,
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
