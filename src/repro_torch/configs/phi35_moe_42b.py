"""Phi-3.5-MoE 42B (6.6B active): 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, n_experts=16, top_k=2, norm="layernorm",
    rope_theta=10000.0)

# capacity_factor 2.5: see dbrx_132b.py — smoke is effectively dropless so
# the consistency test checks routing determinism, not capacity-drop edges.
SMOKE = dataclasses.replace(
    CONFIG, arch="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab_size=256, n_experts=4, top_k=2,
    capacity_factor=2.5)
