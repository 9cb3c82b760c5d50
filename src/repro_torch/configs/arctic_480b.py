"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

Assigned: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2.  Dense-MoE hybrid: a parallel dense FFN residual rides
alongside the routed experts every layer.  Adafactor (factored second
moment) so 480B of state fits the pod (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    pattern=("global",),
    num_experts=128,
    num_experts_per_tok=2,
    moe_dense_ff=4864,
    capacity_factor=1.25,
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    optimizer="adafactor",
    # §Perf arctic it.1: mb=4 cuts expert-weight gather+grad traffic 1.7x
    # (also required: per-mb batch must divide the 32-way multipod fsdp)
    microbatches=4,
    reduce_dtype="bf16",
)

SMOKE = ModelConfig(
    name="arctic-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    pattern=("global",),
    num_experts=8,
    num_experts_per_tok=2,
    moe_dense_ff=96,
    activation="swiglu",
    glu=True,
    tie_embeddings=False,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
