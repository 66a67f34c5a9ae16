"""Model registry: one uniform interface over the zoo's families (port of
``repro.models.registry``).

  model = get_model(cfg)
  model.init_params(seed_or_generator, device=...) / abstract_params /
      param_specs / param_shapes / compute_params
  model.param_view({name: tensor})          the tree forward_train reads
  model.forward_train(params, batch)        batch dict (family-specific keys)
  model.prefill(params, batch, max_len)
  model.decode_step(params, token, state)
  model.init_decode_state(batch, max_len) / decode_state_specs
  model.input_specs(shape)                  meta-tensor stand-ins

``params`` is the model's ``nn.Module``: dense, moe and vlm go through
``transformer.py``, ssm through ``rwkv6_model.py``, hybrid through
``zamba2.py`` and audio through ``encdec.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import (common, encdec, rwkv6_model, transformer,
                                zamba2)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable         # (generator|seed, dtype, device) -> module
    abstract_params: Callable     # () -> module on the meta device
    param_specs: Callable         # () -> logical-axes tree (reference layout)
    param_shapes: Callable        # (params) -> shapes tree (reference layout)
    compute_params: Callable      # (params) -> compute-dtype copy
    param_view: Callable          # ({param name: tensor}) -> params tree
    forward_train: Callable       # (params, batch) -> (logits, aux)
    prefill: Callable             # (params, batch, max_len) -> (logits, state)
    decode_step: Callable         # (params, token, state) -> (logits, state)
    init_decode_state: Callable   # (batch, max_len, device) -> state
    decode_state_specs: Callable
    input_specs: Callable         # (ShapeConfig) -> dict of meta tensors

    def batch_tokens(self, shape: ShapeConfig) -> int:
        """Tokens processed per step for this (cfg, shape): audio counts
        its decoder tokens (and, at prefill, the frames)."""
        if shape.kind == "train":
            if self.cfg.family == "audio":
                return shape.global_batch * encdec.dec_len(
                    self.cfg, shape.seq_len, "train")
            return shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            n = shape.global_batch * shape.seq_len
            if self.cfg.family == "audio":
                n += shape.global_batch * encdec.dec_len(
                    self.cfg, shape.seq_len, "prefill")
            return n
        return shape.global_batch  # decode: 1 token per sequence


def _tok_specs(shape: ShapeConfig, seq):
    return torch.empty((shape.global_batch, seq), dtype=torch.int32,
                       device="meta")


def _decoder_like(cfg: ModelConfig, mod) -> ModelAPI:
    n_img = cfg.n_image_tokens
    skeleton = mod.abstract_params(cfg)

    def param_view(tensors):
        return common.param_view(skeleton, tensors)

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
        param_view=param_view,
        forward_train=forward_train, prefill=prefill, decode_step=decode_step,
        init_decode_state=init_decode_state,
        decode_state_specs=lambda: mod.decode_state_specs(cfg),
        input_specs=input_specs)


def _encdec_api(cfg: ModelConfig) -> ModelAPI:
    skeleton = encdec.abstract_params(cfg)

    def init_params(generator=None, dtype=None, device=None):
        return encdec.init_params(cfg, generator, dtype,
                                  device=resolve_device(device))

    def forward_train(params, batch):
        return encdec.forward_train(params, cfg, batch)

    def prefill(params, batch, max_len):
        return encdec.prefill(params, cfg, batch, max_len)

    def decode_step(params, token, state):
        return encdec.decode_step(params, cfg, token, state)

    def init_decode_state(batch, max_len, enc_len=None, device=None):
        dev = device if device == "meta" else resolve_device(device)
        return encdec.init_decode_state(cfg, batch, max_len,
                                        enc_len or max_len, device=dev)

    def input_specs(shape: ShapeConfig):
        dt = transformer.torch_dtype(cfg.compute_dtype)
        frames = torch.empty((shape.global_batch, shape.seq_len,
                              cfg.d_model), dtype=dt, device="meta")
        if shape.kind in ("train", "prefill"):
            dl = encdec.dec_len(cfg, shape.seq_len, shape.kind)
            specs = {"frames": frames, "dec_tokens": _tok_specs(shape, dl)}
            if shape.kind == "train":
                specs["labels"] = _tok_specs(shape, dl)
                specs["loss_mask"] = torch.empty(
                    (shape.global_batch, dl), dtype=dt, device="meta")
            return specs
        dl = encdec.dec_len(cfg, shape.seq_len, "prefill")
        state = encdec.init_decode_state(cfg, shape.global_batch, dl + 256,
                                         shape.seq_len, device="meta")
        return {"token": _tok_specs(shape, 1), "state": state}

    return ModelAPI(
        cfg=cfg, init_params=init_params,
        abstract_params=lambda: encdec.abstract_params(cfg),
        param_specs=lambda: encdec.param_specs(cfg),
        param_shapes=encdec.param_shapes, compute_params=encdec.compute_copy,
        param_view=lambda tensors: common.param_view(skeleton, tensors),
        forward_train=forward_train, prefill=prefill, decode_step=decode_step,
        init_decode_state=init_decode_state,
        decode_state_specs=lambda: encdec.decode_state_specs(cfg),
        input_specs=input_specs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_like(cfg, transformer)
    if cfg.family == "ssm":
        return _decoder_like(cfg, rwkv6_model)
    if cfg.family == "hybrid":
        return _decoder_like(cfg, zamba2)
    if cfg.family == "audio":
        return _encdec_api(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
