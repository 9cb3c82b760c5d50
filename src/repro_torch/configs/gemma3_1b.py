"""gemma3-1b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3-1b-pt].

Assigned: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Pattern (local×5, global) ×4 + 2 tail local layers; window 512; GeGLU;
RoPE theta 1M on globals (single theta used here); qk-norm; emb scaling.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=("local",) * 5 + ("global",),
    window_size=512,
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    activation="geglu",
    glu=True,
    emb_scale=True,
    tie_embeddings=True,
    optimizer="adamw",
    microbatches=2,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("local", "local", "global"),
    window_size=16,
    use_qk_norm=True,
    activation="geglu",
    glu=True,
    emb_scale=True,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=16,
    remat="none",
)
