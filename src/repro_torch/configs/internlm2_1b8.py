"""InternLM2-1.8B: llama-arch GQA [arXiv:2403.17297]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92544, rope_theta=1000000.0)

SMOKE = dataclasses.replace(
    CONFIG, arch="internlm2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256)
