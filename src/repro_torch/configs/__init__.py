"""Assigned-architecture configs (exact published dims) + reduced smoke
variants. ``get_config(arch)`` / ``get_smoke_config(arch)`` / ``ARCHS``.

The port's own copy of ``repro.configs``: the same dataclasses and the
same published widths, imported from nowhere else."""
from __future__ import annotations

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shapes_for, SUBQUADRATIC_FAMILIES)

from repro_torch.configs import (dbrx_132b, phi35_moe_42b, zamba2_7b,
                                 rwkv6_1b6, internlm2_1b8, yi_6b, qwen15_4b,
                                 gemma2_27b, whisper_base,
                                 llava_next_mistral_7b)

_MODULES = {
    "dbrx-132b": dbrx_132b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "zamba2-7b": zamba2_7b,
    "rwkv6-1.6b": rwkv6_1b6,
    "internlm2-1.8b": internlm2_1b8,
    "yi-6b": yi_6b,
    "qwen1.5-4b": qwen15_4b,
    "gemma2-27b": gemma2_27b,
    "whisper-base": whisper_base,
    "llava-next-mistral-7b": llava_next_mistral_7b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shapes_for", "ARCHS",
           "get_config", "get_smoke_config", "SUBQUADRATIC_FAMILIES"]
