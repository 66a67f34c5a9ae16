"""Zamba2-7B hybrid: Mamba2 backbone + 2 alternating shared attention blocks
[arXiv:2411.15242]. 81 mamba blocks; shared block every 6."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6, n_shared_blocks=2)

SMOKE = dataclasses.replace(
    CONFIG, arch="zamba2-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
    attn_every=2)
