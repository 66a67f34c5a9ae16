"""RWKV6 "Finch" block (port of ``repro.models.rwkv6``; arXiv:2404.05892):
token-shift time-mix with data-dependent decay, the WKV6 recurrence with
per-channel decay + bonus (``gla`` in "bonus" mode), a per-head output
GroupNorm, and the squared-ReLU channel-mix FFN.

The reference's simplifications are kept: static token-shift mix
coefficients per projection (r/k/v/g), LoRA only on the decay path.  The
decay LoRA runs in float32 (``decay_w0``, ``decay_a``, ``decay_b`` and
``bonus`` are read in float32, as the output GroupNorm's ``ln_out``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import gla
from repro_torch.sharding.rules import constrain

_FLOAT32_LEAVES = ("decay_w0", "decay_a", "decay_b", "bonus")


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64
    d_ff: int = 7168
    decay_lora: int = 64
    chunk: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


class TimeMix(nn.Module):
    def __init__(self, cfg: RWKV6Config, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        fw = dict(device=device, dtype=dtype)
        self.mix = cm.full((4, d), 0.5, **fw)          # r, k, v, g shift mixes
        self.mix_w = cm.full((d,), 0.5, **fw)          # decay shift mix
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, cm.dense_init((d, d), (0,), **kw))
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        self.decay_w0 = cm.full((d,), -6.0, **fw)
        self.decay_a = cm.dense_init((d, cfg.decay_lora), (0,), **kw)
        self.decay_b = cm.dense_init((cfg.decay_lora, d), (0,), **kw)
        self.bonus = cm.zeros((nh, hd), **fw)           # u
        self.ln_out = cm.LayerNorm(d, **fw)             # group-norm per head


class ChannelMix(nn.Module):
    def __init__(self, cfg: RWKV6Config, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.mix = cm.full((2, d), 0.5, device=device, dtype=dtype)  # k, r
        self.w_k = cm.dense_init((d, cfg.d_ff), (0,), **kw)
        self.w_v = cm.dense_init((cfg.d_ff, d), (0,), **kw)
        self.w_r = cm.dense_init((d, d), (0,), **kw)


class Block(nn.Module):
    def __init__(self, cfg: RWKV6Config, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln1 = cm.LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = cm.LayerNorm(cfg.d_model, device=device, dtype=dtype)
        self.att = TimeMix(cfg, **kw)
        self.ffn = ChannelMix(cfg, **kw)


def init(cfg: RWKV6Config, *, generator=None, device=None,
         dtype=torch.float32) -> Block:
    return Block(cfg, generator=generator, device=device, dtype=dtype)


def specs(cfg: RWKV6Config):
    return {
        "ln1": cm.layernorm_specs(),
        "ln2": cm.layernorm_specs(),
        "att": {
            "mix": (None, "act_in"), "mix_w": ("act_in",),
            "w_r": ("act_in", "heads_embed"),
            "w_k": ("act_in", "heads_embed"),
            "w_v": ("act_in", "heads_embed"),
            "w_g": ("act_in", "heads_embed"),
            "w_o": ("heads_embed", "act_in"),
            "decay_w0": ("act_in",), "decay_a": ("act_in", "lora"),
            "decay_b": ("lora", "act_in"),
            "bonus": ("heads", "head_dim"),
            "ln_out": {"scale": ("heads_embed",), "bias": ("heads_embed",)},
        },
        "ffn": {
            "mix": (None, "act_in"),
            "w_k": ("act_in", "mlp"), "w_v": ("mlp", "act_in"),
            "w_r": (None, None),
        },
    }


def keeps_float32(module: nn.Module, name: str) -> bool:
    """The leaves the reference reads in float32 (``compute_copy``)."""
    return cm.is_norm(module) or (isinstance(module, TimeMix)
                                  and name in _FLOAT32_LEAVES)


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / ``last`` for t=0). x: (b, s, d)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _time_mix_inputs(p, cfg: RWKV6Config, x, last=None):
    b, s, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    xs = _shift(x, last)
    xr = _mix(x, xs, p.mix[0])
    xk = _mix(x, xs, p.mix[1])
    xv = _mix(x, xs, p.mix[2])
    xg = _mix(x, xs, p.mix[3])
    xw = _mix(x, xs, p.mix_w)
    r = torch.einsum("bsd,de->bse", xr, p.w_r.to(x.dtype))
    k = torch.einsum("bsd,de->bse", xk, p.w_k.to(x.dtype))
    v = torch.einsum("bsd,de->bse", xv, p.w_v.to(x.dtype))
    g = torch.einsum("bsd,de->bse", xg, p.w_g.to(x.dtype))
    # data-dependent decay (float32): logw in (-inf, 0)
    f32 = torch.float32
    lora = torch.einsum("bsl,ld->bsd", torch.tanh(torch.einsum(
        "bsd,dl->bsl", xw.to(f32), p.decay_a.to(f32))), p.decay_b.to(f32))
    logw = -torch.exp(p.decay_w0.to(f32) + lora)
    heads = lambda a: constrain(a.reshape(b, s, nh, hd).transpose(1, 2),
                                "batch", "heads", None, None)
    return heads(r), heads(k), heads(v), g, heads(logw)


def _time_mix_out(p, cfg: RWKV6Config, y, g, x_dtype):
    """Per-head GroupNorm, the gate, the output projection."""
    b, nh, s, hd = y.shape
    yf = y.to(torch.float32)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.mean((yf - mu) ** 2, dim=-1, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    scale = p.ln_out.scale.to(torch.float32).reshape(nh, 1, hd)
    bias = p.ln_out.bias.to(torch.float32).reshape(nh, 1, hd)
    y = (yf * scale + bias).to(x_dtype)
    y = y.transpose(1, 2).reshape(b, s, nh * hd)
    y = y * F.silu(g).to(x_dtype)
    return torch.einsum("bsd,de->bse", y, p.w_o.to(x_dtype))


def time_mix_train(p, cfg: RWKV6Config, x):
    r, k, v, g, logw = _time_mix_inputs(p, cfg, x)
    y, _ = gla.chunked_gla(r, k, v, logw, u=p.bonus.to(torch.float32),
                           chunk=cfg.chunk, mode="bonus")
    return _time_mix_out(p, cfg, y, g, x.dtype)


def channel_mix_train(p, x, last=None):
    xs = _shift(x, last)
    xk = _mix(x, xs, p.mix[0])
    xr = _mix(x, xs, p.mix[1])
    k = torch.einsum("bsd,df->bsf", xk, p.w_k.to(x.dtype))
    k = torch.square(F.relu(k))
    kv = torch.einsum("bsf,fd->bsd", k, p.w_v.to(x.dtype))
    r = torch.einsum("bsd,de->bse", xr, p.w_r.to(x.dtype))
    return torch.sigmoid(r) * kv


def init_state(cfg: RWKV6Config, batch, dtype=torch.float32, device=None):
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "att_x": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "ffn_x": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                           device=device),
    }


def state_specs():
    return {"att_x": ("batch", None, "embed"),
            "ffn_x": ("batch", None, "embed"),
            "wkv": ("batch", "heads", None, None)}


def block_decode(p, cfg: RWKV6Config, x, state):
    """One token through time-mix + channel-mix (pre-LN). x: (b, 1, d).
    Returns (out, new state)."""
    xa = cm.layernorm(p.ln1, x)
    r, k, v, g, logw = _time_mix_inputs(p.att, cfg, xa, state["att_x"])
    y, wkv = gla.gla_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 logw[:, :, 0], state["wkv"],
                                 u=p.att.bonus.to(torch.float32),
                                 mode="bonus")
    h = x + _time_mix_out(p.att, cfg, y[:, :, None, :], g, x.dtype)
    hf = cm.layernorm(p.ln2, h)
    out = h + channel_mix_train(p.ffn, hf, state["ffn_x"])
    return out, {"att_x": xa, "ffn_x": hf, "wkv": wkv}


def block_train(p, cfg: RWKV6Config, x):
    h = x + time_mix_train(p.att, cfg, cm.layernorm(p.ln1, x))
    return h + channel_mix_train(p.ffn, cm.layernorm(p.ln2, h))


def block_prefill(p, cfg: RWKV6Config, x, state):
    """Full-sequence forward returning the carried decode state (the wkv
    final state from ``chunked_gla`` and the last token's shift inputs)."""
    xa = cm.layernorm(p.ln1, x)
    r, k, v, g, logw = _time_mix_inputs(p.att, cfg, xa, state["att_x"])
    y, wkv = gla.chunked_gla(r, k, v, logw,
                             u=p.att.bonus.to(torch.float32),
                             initial_state=state["wkv"],
                             chunk=cfg.chunk, mode="bonus")
    h = x + _time_mix_out(p.att, cfg, y, g, x.dtype)
    hf = cm.layernorm(p.ln2, h)
    out = h + channel_mix_train(p.ffn, hf, state["ffn_x"])
    return out, {"att_x": xa[:, -1:], "ffn_x": hf[:, -1:], "wkv": wkv}
