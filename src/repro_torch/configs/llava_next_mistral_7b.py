"""LLaVA-NeXT (mistral-7b backbone); anyres tiling frontend stubbed to
precomputed patch embeddings [hf:llava-hf/llava-v1.6-mistral-7b-hf].
2880 image tokens = anyres 4+1 tiles x 576 patches."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, rope_theta=1000000.0, n_image_tokens=2880)

SMOKE = dataclasses.replace(
    CONFIG, arch="llava-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, n_image_tokens=8)
