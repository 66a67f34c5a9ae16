"""Whisper-base enc-dec backbone; conv frontend stubbed [arXiv:2212.04356]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-base", family="audio",
    n_layers=12, n_enc_layers=6, n_dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51865, norm="layernorm", activation="gelu")

SMOKE = dataclasses.replace(
    CONFIG, arch="whisper-smoke", n_layers=4, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256)
