"""Qwen1.5-4B: QKV bias, MHA-equivalent GQA (kv=20) [hf:Qwen/Qwen1.5-4B]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab_size=151936, use_qkv_bias=True, rope_theta=5000000.0,
    # 20 heads do not divide a 16-way tensor-parallel axis: under a mesh
    # attention's queries are sharded over the sequence on "model" instead
    # (attention._qkv's constrain)
    attn_seq_shard=True)

SMOKE = dataclasses.replace(
    CONFIG, arch="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256)
