"""RWKV6-1.6B language model (port of ``repro.models.rwkv6_model``):
attention-free, with an O(1) decode state.

The layers are an ``nn.ModuleList``; ``param_shapes`` gives the
reference's stacked tree (a leading ``n_layers`` axis).  The decode state
is the reference's tree, ``{"layers": {"att_x", "ffn_x", "wkv"}, "len"}``,
each leaf stacked over the layers (``len`` a host int); ``decode_step``
writes it in place.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import rwkv6
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding.rules import constrain_state


def _cfg(cfg: ModelConfig) -> rwkv6.RWKV6Config:
    return rwkv6.RWKV6Config(
        d_model=cfg.d_model, head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
        decay_lora=cfg.decay_lora, chunk=cfg.ssm_chunk)


class RWKV6LM(nn.Module):
    """``embed`` (tied), ``ln0`` (RWKV's post-embedding LayerNorm),
    ``layers``, ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = cm.Embedding(cfg.vocab_size, cfg.d_model,
                                  generator=generator, **kw)
        self.ln0 = cm.LayerNorm(cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            rwkv6.init(_cfg(cfg), generator=generator, **kw)
            for _ in range(cfg.n_layers))
        self.final_norm = cm.LayerNorm(cfg.d_model, **kw)


def init_params(cfg: ModelConfig, generator=None, dtype=None, device=None):
    """Seeded random weights: ``generator`` is a ``torch.Generator`` on
    ``device`` or an int seed."""
    return RWKV6LM(cfg, generator=cm.make_generator(generator, device),
                   device=device, dtype=dtype)


def abstract_params(cfg: ModelConfig):
    return RWKV6LM(cfg, device="meta")


def param_shapes(params) -> dict:
    return {"embed": cm.shape_tree(params.embed),
            "ln0": cm.shape_tree(params.ln0),
            "layers": cm.shape_tree(params.layers[0], (len(params.layers),)),
            "final_norm": cm.shape_tree(params.final_norm)}


def param_specs(cfg: ModelConfig):
    return {
        "embed": cm.embed_specs(),
        "ln0": cm.layernorm_specs(),
        "layers": cm.add_layer_axis_to_specs(rwkv6.specs(_cfg(cfg))),
        "final_norm": cm.layernorm_specs(),
    }


def compute_copy(params):
    """The weights cast to the compute dtype once; the LayerNorms and the
    float32 decay path (``rwkv6.keeps_float32``) shared with ``params``."""
    return cm.compute_copy(params, torch_dtype(params.cfg.compute_dtype),
                           rwkv6.keeps_float32)


def _embed_in(params, cfg: ModelConfig, tokens):
    h = cm.embed_lookup(params.embed, tokens.long()).to(
        torch_dtype(cfg.compute_dtype))
    return cm.layernorm(params.ln0, h)


def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens: (B, S) int. Returns (logits (B, S, V), aux = 0); each layer
    under ``cm.remat`` when autograd records."""
    rcfg = _cfg(cfg)
    h = _embed_in(params, cfg, tokens)
    records = torch.is_grad_enabled() and h.requires_grad
    for p in params.layers:
        body = functools.partial(rwkv6.block_train, p, rcfg)
        h = (cm.remat(cfg, body) if records else body)(h)
    h = cm.layernorm(params.final_norm, h)
    return (cm.embed_logits(params.embed, h),
            torch.zeros((), dtype=torch.float32, device=h.device))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int = 0,
                      dtype=torch.bfloat16, device=None):
    """max_len unused: the state is O(1) in the sequence length.  The
    shift inputs are in the compute dtype, ``wkv`` float32."""
    one = rwkv6.init_state(_cfg(cfg), batch, torch_dtype(cfg.compute_dtype),
                           device="meta")
    return {"layers": {k: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                                      dtype=a.dtype, device=device)
                       for k, a in one.items()},
            "len": 0}


def decode_state_specs(cfg: ModelConfig):
    return {"layers": cm.add_layer_axis_to_specs(rwkv6.state_specs()),
            "len": ()}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, state):
    """token: (B, 1) int. Returns (logits (B, 1, V), the state written in
    place with ``len`` + 1)."""
    rcfg = _cfg(cfg)
    h = cm.step_layers(params.layers, _embed_in(params, cfg, token),
                       state["layers"],
                       lambda p, h, st: rwkv6.block_decode(p, rcfg, h, st))
    h = cm.layernorm(params.final_norm, h)
    return (cm.embed_logits(params.embed, h),
            {"layers": state["layers"], "len": int(state["len"]) + 1})


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, max_len: int = 0,
            extra_embeds=None, cache_dtype=torch.bfloat16):
    """Run the prompt from a zero state. Returns (logits of the last
    position, state with ``len`` = the prompt's length)."""
    h = _embed_in(params, cfg, tokens)
    state = constrain_state(
        init_decode_state(cfg, tokens.shape[0], device=h.device),
        decode_state_specs(cfg))
    rcfg = _cfg(cfg)
    h = cm.step_layers(params.layers, h, state["layers"],
                       lambda p, h, st: rwkv6.block_prefill(p, rcfg, h, st))
    h = cm.layernorm(params.final_norm, h)
    state["len"] = tokens.shape[1]
    return cm.embed_logits(params.embed, h[:, -1:]), state
