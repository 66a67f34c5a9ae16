"""Model registry: one uniform interface over the zoo's families (port of
``repro.models.registry``).

  model = get_model(cfg)
  model.init_params(seed_or_generator, device=...) / abstract_params /
      param_specs / param_shapes / compute_params
  model.forward_train(params, batch)        batch dict (family-specific keys)
  model.prefill(params, batch, max_len)
  model.decode_step(params, token, state)
  model.init_decode_state(batch, max_len) / decode_state_specs
  model.input_specs(shape)                  meta-tensor stand-ins

``params`` is the model's ``nn.Module``.  The families that go through
``transformer.py`` are ported (dense, moe, vlm); ``ssm``, ``hybrid`` and
``audio`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer

NOT_PORTED = {
    "ssm": "rwkv6 (models/rwkv6.py, rwkv6_model.py)",
    "hybrid": "zamba2 (models/zamba2.py, mamba2.py)",
    "audio": "whisper (models/encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable         # (generator|seed, dtype, device) -> module
    abstract_params: Callable     # () -> module on the meta device
    param_specs: Callable         # () -> logical-axes tree (reference layout)
    param_shapes: Callable        # (params) -> shapes tree (reference layout)
    compute_params: Callable      # (params) -> compute-dtype copy
    forward_train: Callable       # (params, batch) -> (logits, aux)
    prefill: Callable             # (params, batch, max_len) -> (logits, state)
    decode_step: Callable         # (params, token, state) -> (logits, state)
    init_decode_state: Callable   # (batch, max_len, device) -> state
    decode_state_specs: Callable
    input_specs: Callable         # (ShapeConfig) -> dict of meta tensors

    def batch_tokens(self, shape: ShapeConfig) -> int:
        """Tokens processed per step for this (cfg, shape)."""
        if shape.kind in ("train", "prefill"):
            return shape.global_batch * shape.seq_len
        return shape.global_batch  # decode: 1 token per sequence


def _tok_specs(shape: ShapeConfig, seq):
    return torch.empty((shape.global_batch, seq), dtype=torch.int32,
                       device="meta")


def _decoder_like(cfg: ModelConfig, mod) -> ModelAPI:
    n_img = cfg.n_image_tokens

    def init_params(generator=None, dtype=None, device=None):
        return mod.init_params(cfg, generator, dtype,
                               device=resolve_device(device))

    def forward_train(params, batch):
        return mod.forward_train(params, cfg, batch["tokens"],
                                 batch.get("extra_embeds"))

    def prefill(params, batch, max_len):
        return mod.prefill(params, cfg, batch["tokens"], max_len,
                           extra_embeds=batch.get("extra_embeds"))

    def decode_step(params, token, state):
        return mod.decode_step(params, cfg, token, state)

    def init_decode_state(batch, max_len, device=None):
        dev = device if device == "meta" else resolve_device(device)
        return mod.init_decode_state(cfg, batch, max_len, device=dev)

    def input_specs(shape: ShapeConfig):
        dt = transformer.torch_dtype(cfg.compute_dtype)
        if shape.kind in ("train", "prefill"):
            text = shape.seq_len - n_img
            specs = {"tokens": _tok_specs(shape, text)}
            if n_img:
                specs["extra_embeds"] = torch.empty(
                    (shape.global_batch, n_img, cfg.d_model), dtype=dt,
                    device="meta")
            if shape.kind == "train":
                specs["labels"] = _tok_specs(shape, text if not n_img
                                             else shape.seq_len)
                specs["loss_mask"] = torch.empty(
                    (shape.global_batch,
                     shape.seq_len if n_img else text), dtype=dt,
                    device="meta")
            return specs
        # decode: one token + cache of seq_len
        state = mod.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                      device="meta")
        return {"token": _tok_specs(shape, 1), "state": state}

    return ModelAPI(
        cfg=cfg, init_params=init_params,
        abstract_params=lambda: mod.abstract_params(cfg),
        param_specs=lambda: mod.param_specs(cfg),
        param_shapes=mod.param_shapes, compute_params=mod.compute_copy,
        forward_train=forward_train, prefill=prefill, decode_step=decode_step,
        init_decode_state=init_decode_state,
        decode_state_specs=lambda: mod.decode_state_specs(cfg),
        input_specs=input_specs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_like(cfg, transformer)
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({NOT_PORTED[cfg.family]}) is not "
            "ported yet: ROADMAP.md Queue 1 item 15 step 4")
    raise ValueError(f"unknown family {cfg.family!r}")
