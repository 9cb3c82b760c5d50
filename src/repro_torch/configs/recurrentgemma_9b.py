"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

Assigned: 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Griffin pattern (rglru, rglru, local-attn) ×12 + 2 tail rglru; window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=4096,
    conv1d_width=4,
    activation="geglu",
    glu=True,
    emb_scale=True,
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    pattern=("rglru", "rglru", "local"),
    window_size=16,
    rnn_width=64,
    activation="geglu",
    glu=True,
    emb_scale=True,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
