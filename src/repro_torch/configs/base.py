"""Config schema for the model zoo + the assigned input-shape grid."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // n_heads
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    activation: str = "silu"               # silu | gelu
    use_qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_softcap: float | None = None      # gemma2: 50.0
    final_softcap: float | None = None     # gemma2: 30.0
    query_scale: float | None = None
    sliding_window: int | None = None
    layer_pattern: str = "full"            # full | local_global (gemma2)
    embed_scale: bool = False              # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    post_norms: bool = False               # gemma2 sandwich norms
    attn_seq_shard: bool = False           # context-parallel attention
                                           # (for n_heads % TP != 0)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    decay_lora: int = 64                   # rwkv6
    attn_every: int = 0                    # zamba2: shared attn every k blocks
    n_shared_blocks: int = 2
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # vlm (llava)
    n_image_tokens: int = 0
    # execution policy
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"                    # none | full | dots
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        if self.family in ("dense", "vlm"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            mlp = 3 * d * self.d_ff
            return emb + self.n_layers * (attn + mlp)
        if self.family == "moe":
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            return emb + self.n_layers * (attn + moe)
        if self.family == "ssm":  # rwkv6
            att = 6 * d * d + 2 * d * self.decay_lora
            ffn = 2 * d * self.d_ff + d * d
            return emb + self.n_layers * (att + ffn)
        if self.family == "hybrid":  # zamba2
            di = self.ssm_expand * d
            proj = d * (2 * di + 2 * self.ssm_state + di // self.ssm_head_dim)
            mamba = proj + di * d
            shared = (2 * d) * self.n_heads * hd * 3 + self.n_heads * hd * d \
                + 2 * (2 * d) * self.d_ff + self.d_ff * d
            return emb + self.n_layers * mamba + self.n_shared_blocks * shared
        if self.family == "audio":  # whisper enc-dec
            attn = 4 * d * d
            mlp = 2 * d * self.d_ff
            per = attn + mlp
            return emb + self.n_enc_layers * per + self.n_dec_layers * (per + attn)
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        emb = self.vocab_size * d
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        moe_active = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        return emb + self.n_layers * (attn + moe_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned LM shape grid (applies to every arch; long_500k only where
# sub-quadratic — see DESIGN.md §Arch-applicability).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        out.append(SHAPES["long_500k"])
    return out
