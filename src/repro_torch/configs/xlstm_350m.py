"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

Assigned: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
xLSTM[7:1]: pattern of 7 mLSTM + 1 sLSTM per 8 layers (paper's LM ratio);
blocks carry their own projections (d_ff=0).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    glu=False,
    activation="gelu",
    tie_embeddings=True,
    optimizer="adamw",
    # §Perf xlstm iterations: TP is pure overhead at 350M — remap model
    # axis to data parallelism; single loss chunk; bf16 reduces (TPU)
    tp_mode="dp",
    microbatches=1,
    loss_chunk=4096,
    reduce_dtype="bf16",
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=256,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    glu=False,
    activation="gelu",
    dtype="float32",
    param_dtype="float32",
    attn_chunk=32,
    remat="none",
)
