"""RWKV6 'Finch' 1.6B: attention-free, data-dependent decay [arXiv:2404.05892]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65536, head_dim=64, decay_lora=64)

SMOKE = dataclasses.replace(
    CONFIG, arch="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, decay_lora=8)
