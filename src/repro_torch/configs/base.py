"""Model configuration schema shared by all architectures."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture = one frozen config (hashable)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # per-layer kind pattern, tiled over the stack; kinds:
    #   "global" full attn | "local" sliding-window attn | "rglru" Griffin
    #   block | "mlstm" / "slstm" xLSTM blocks
    pattern: Tuple[str, ...] = ("global",)
    window_size: int = 0  # sliding window for "local"
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    use_qk_norm: bool = False
    activation: str = "silu"  # gelu | silu | geglu | swiglu | relu
    glu: bool = True  # gated FFN (GeGLU/SwiGLU)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_ff: int = 0  # parallel dense-residual FFN (arctic) / shared expert
    capacity_factor: float = 1.25
    router_mode: str = "topk"  # topk | sampled (C-SAW selection machinery)

    # recurrent blocks
    rnn_width: int = 0  # RG-LRU width (defaults to d_model)
    conv1d_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334

    # embeddings / head
    tie_embeddings: bool = True
    emb_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    norm_eps: float = 1e-6
    frontend: str = "none"  # none | audio | vision (stub embeddings)
    frontend_tokens: int = 0  # prefix length provided by the frontend stub

    # numerics / compilation
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    scan_blocks: bool = True
    remat: str = "full"  # full | none
    attn_chunk: int = 1024  # online-softmax KV chunk
    microbatches: int = 1  # gradient accumulation (activation memory / m)
    loss_chunk: int = 512  # chunked-CE sequence block (bigger = fewer head passes)

    # which optimizer the launcher should pick (adafactor for >=100B)
    optimizer: str = "adamw"
    # tensor-parallel mode: "model" (TP over the model axis) or "dp" (remap
    # the model axis to extra data parallelism — small archs where TP is
    # pure collective overhead; EXPERIMENTS.md §Perf xlstm iterations)
    tp_mode: str = "model"
    # dtype of cross-chip partial-sum reductions for row-parallel matmuls
    # ("bf16" halves TP wire bytes vs the f32 default; §Perf gemma-7b it.1)
    reduce_dtype: str = "f32"
    # dtype of materialized attention score blocks ("bf16" halves the HBM
    # traffic that a fused flash kernel would avoid; §Perf gemma-7b it.2)
    attn_scores_dtype: str = "f32"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind list: pattern tiled + truncated to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])

    @property
    def n_rep(self) -> int:
        """Number of whole pattern repetitions (the scan length)."""
        return self.num_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        """Layers beyond the last whole repetition (unrolled)."""
        return self.num_layers - self.n_rep * len(self.pattern)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, h, kv, hd, f = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim, self.d_ff
        per_layer = 0
        for kind in self.layer_kinds():
            if kind in ("global", "local", "global_dense"):
                per_layer += d * (h + 2 * kv) * hd + h * hd * d  # qkvo
                if self.num_experts and kind != "global_dense":
                    per_layer += d * self.num_experts  # router
                    nmat = 3 if self.glu else 2
                    per_layer += self.num_experts * nmat * d * f
                    if self.moe_dense_ff:
                        per_layer += nmat * d * self.moe_dense_ff
                elif f:
                    per_layer += (3 if self.glu else 2) * d * f
            elif kind == "rglru":
                w = self.rnn_width or d
                per_layer += 2 * d * w + w * self.conv1d_width + 2 * w * w // 1 + w * d
                per_layer += (3 if self.glu else 2) * d * f  # its own MLP
            elif kind == "mlstm":
                up = int(d * self.mlstm_proj_factor)
                per_layer += 2 * d * up + 3 * up * up // max(self.num_heads, 1) + up * d
            elif kind == "slstm":
                per_layer += 4 * d * d + int(d * self.slstm_proj_factor) * d * 2
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return per_layer + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        nmat = 3 if self.glu else 2
        unused = (self.num_experts - self.num_experts_per_tok) * nmat * d * f
        n_moe_layers = sum(
            1 for k in self.layer_kinds() if k == "global"
        )
        return self.param_count() - unused * n_moe_layers
