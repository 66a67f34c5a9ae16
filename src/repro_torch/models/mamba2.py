"""Mamba2 (SSD) block, zamba2's backbone mixer (port of
``repro.models.mamba2``; arXiv:2405.21060, simplified to ngroups=1):
in_proj -> [z (gate), x, B, C, dt]; a depthwise causal conv (window 4)
over (x, B, C); the SSD recurrence with a per-head scalar decay
exp(-exp(A_log)·dt) (``gla`` in "inclusive" mode); the D·x skip; a gated
RMSNorm; out_proj.

``dt``'s softplus, ``dt_bias`` and ``-exp(a_log)`` are float32, as in
the reference; decode carries (conv tail, SSD state).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import gla
from repro_torch.sharding.rules import constrain

_FLOAT32_LEAVES = ("a_log", "dt_bias")


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class Mamba2(nn.Module):
    def __init__(self, cfg: Mamba2Config, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        di, ds, nh = cfg.d_inner, cfg.d_state, cfg.n_heads
        kw = dict(generator=generator, device=device, dtype=dtype)
        fw = dict(device=device, dtype=dtype)
        proj_out = 2 * di + 2 * ds + nh   # z, x, B, C, dt
        self.w_in = cm.dense_init((cfg.d_model, proj_out), (0,), **kw)
        self.conv_w = cm.dense_init((cfg.conv_width, di + 2 * ds), (0,),
                                    scale=1.0, **kw)
        self.conv_b = cm.zeros((di + 2 * ds,), **fw)
        self.a_log = cm.param(torch.log(torch.linspace(1.0, 16.0, nh, **fw)))
        self.dt_bias = cm.zeros((nh,), **fw)
        self.d_skip = cm.ones((nh,), **fw)
        self.norm = cm.RMSNorm(di, **fw)
        self.w_out = cm.dense_init((di, cfg.d_model), (0,), **kw)


def init(cfg: Mamba2Config, *, generator=None, device=None,
         dtype=torch.float32) -> Mamba2:
    return Mamba2(cfg, generator=generator, device=device, dtype=dtype)


def specs(cfg: Mamba2Config):
    return {
        "w_in": ("embed", "mlp"),
        "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",),
        "a_log": ("heads",),
        "dt_bias": ("heads",),
        "d_skip": ("heads",),
        "norm": cm.rmsnorm_specs(),
        "w_out": ("mlp", "embed"),
    }


def keeps_float32(module: nn.Module, name: str) -> bool:
    """The leaves the reference reads in float32 (``compute_copy``)."""
    return cm.is_norm(module) or (isinstance(module, Mamba2)
                                  and name in _FLOAT32_LEAVES)


def _split_proj(cfg: Mamba2Config, proj):
    di, ds = cfg.d_inner, cfg.d_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * ds]
    dt = proj[..., di + di + 2 * ds:]
    return z, xbc, dt


def _causal_conv(cfg: Mamba2Config, xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, width W. xbc: (b, s, c). conv_state: (b, W-1,
    c) carries the last W-1 inputs for decode continuity."""
    w = cfg.conv_width
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(full[:, i:i + s, :] * conv_w[i].to(xbc.dtype)
              for i in range(w))
    out = F.silu(out + conv_b.to(xbc.dtype))
    return out, full[:, -(w - 1):, :]


def _ssd_inputs(cfg: Mamba2Config, p, xbc, dt):
    di, ds, nh, hd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    x = constrain(xbc[..., :di], "batch", None, "mlp")
    bmat = xbc[..., di:di + ds]
    cmat = xbc[..., di + ds:]
    b, s, _ = x.shape
    f32 = torch.float32
    # jax.nn.softplus: logaddexp(x, 0)
    dt = torch.logaddexp(dt.to(f32) + p.dt_bias.to(f32),
                         torch.zeros((), dtype=f32, device=dt.device))
    a = -torch.exp(p.a_log.to(f32))                               # (nh,)
    logw = (dt * a).transpose(1, 2)[..., None]                    # (b,nh,s,1)
    xh = constrain(x.reshape(b, s, nh, hd).transpose(1, 2),
                   "batch", "heads", None, None)                  # (b,nh,s,hd)
    # dt scales the input (ZOH discretization): k = B, v = dt*x
    v = xh * dt.transpose(1, 2)[..., None].to(xh.dtype)
    k = bmat[:, None].expand(b, nh, s, ds).to(xh.dtype)
    q = cmat[:, None].expand(b, nh, s, ds).to(xh.dtype)
    return q, k, v, logw, xh


def _finish(cfg: Mamba2Config, p, y, xh, z):
    b, nh, s, hd = y.shape
    y = y + p.d_skip.to(y.dtype)[None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(b, s, nh * hd)
    y = cm.rmsnorm(p.norm, y * F.silu(z))
    return torch.einsum("bsd,de->bse", y, p.w_out.to(y.dtype))


def _in_proj(p, x):
    return torch.einsum("bsd,de->bse", x, p.w_in.to(x.dtype))


def apply_train(p, cfg: Mamba2Config, x):
    z, xbc, dt = _split_proj(cfg, _in_proj(p, x))
    xbc, _ = _causal_conv(cfg, xbc, p.conv_w, p.conv_b)
    q, k, v, logw, xh = _ssd_inputs(cfg, p, xbc, dt)
    y, _ = gla.chunked_gla(q, k, v, logw, chunk=cfg.chunk, mode="inclusive")
    return _finish(cfg, p, y, xh, z)


def init_state(cfg: Mamba2Config, batch, dtype=torch.float32, device=None):
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }


def state_specs():
    return {"conv": ("batch", None, "mlp"),
            "ssm": ("batch", "heads", None, None)}


def apply_prefill(p, cfg: Mamba2Config, x, state):
    """Full-sequence forward that also returns the post-sequence state
    (conv tail + SSD final state) for the decode that follows."""
    z, xbc, dt = _split_proj(cfg, _in_proj(p, x))
    xbc, conv_state = _causal_conv(cfg, xbc, p.conv_w, p.conv_b,
                                   state["conv"])
    q, k, v, logw, xh = _ssd_inputs(cfg, p, xbc, dt)
    y, ssm = gla.chunked_gla(q, k, v, logw, initial_state=state["ssm"],
                             chunk=cfg.chunk, mode="inclusive")
    return _finish(cfg, p, y, xh, z), {"conv": conv_state, "ssm": ssm}


def apply_decode(p, cfg: Mamba2Config, x, state):
    """x: (b, 1, d). Returns (out, new_state)."""
    z, xbc, dt = _split_proj(cfg, _in_proj(p, x))
    xbc, conv_state = _causal_conv(cfg, xbc, p.conv_w, p.conv_b,
                                   state["conv"])
    q, k, v, logw, xh = _ssd_inputs(cfg, p, xbc, dt)
    y, ssm = gla.gla_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 logw[:, :, 0], state["ssm"],
                                 mode="inclusive")
    out = _finish(cfg, p, y[:, :, None, :], xh, z)
    return out, {"conv": conv_state, "ssm": ssm}
