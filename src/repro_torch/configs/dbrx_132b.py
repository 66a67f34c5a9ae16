"""DBRX-132B: 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab_size=100352, n_experts=16, top_k=4, norm="layernorm",
    rope_theta=500000.0)

# capacity_factor 2.5: smoke runs are effectively dropless, so the
# prefill/decode consistency test validates cache+routing determinism rather
# than capacity-drop edge semantics (a train-side drop at the decoded
# position is an inherent train/serve divergence of capacity-based MoE —
# decode groups are single tokens and never overflow).
SMOKE = dataclasses.replace(
    CONFIG, arch="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, n_experts=4, top_k=2,
    capacity_factor=2.5)
