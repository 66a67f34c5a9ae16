"""Gemma2-27B: local/global alternating attention, logit softcaps, sandwich
norms, GeGLU [arXiv:2408.00118]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab_size=256000, head_dim=128, activation="gelu",
    attn_softcap=50.0, final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,        # 1/sqrt(d_model/n_heads)
    sliding_window=4096, layer_pattern="local_global",
    embed_scale=True, post_norms=True)

SMOKE = dataclasses.replace(
    CONFIG, arch="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256, sliding_window=32,
    query_scale=(64 / 4) ** -0.5)
