"""Building blocks of the model zoo (port of ``repro.models.common``).

Each block is an ``nn.Module`` that holds its parameters under the
reference's names (``RMSNorm.scale``, ``Embedding.table``, ...), and a
function applies it, as the reference's apply functions do its trees, so
the two packages can be held against each other function by function.
Parameters are float32 masters; a block casts a weight to the
activations' dtype where the reference does (``.to`` of a tensor already
in that dtype is free, which is what ``transformer.compute_copy`` relies
on).

``specs`` trees give every parameter its logical axes, as data:
  layers, embed (d_model), q_heads, kv_heads, head_dim, mlp (d_ff), vocab,
  experts, table_embed, batch, kv_seq
"""
from __future__ import annotations

import math
import types

import torch
from torch import nn
import torch.nn.functional as F


# ---------------------------------------------------------------- init utils
def dense_init(shape, in_axes=(0,), *, generator=None, device=None,
               dtype=torch.float32, scale=1.0) -> nn.Parameter:
    """Truncated-normal fan-in init (LeCun-style), drawn from ``generator``
    (on ``device``; a meta device allocates nothing and draws nothing)."""
    fan_in = 1
    for a in in_axes:
        fan_in *= shape[a]
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.device.type != "meta":
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(scale / math.sqrt(fan_in))
    return nn.Parameter(w, requires_grad=False)


def zeros(shape, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def ones(shape, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    """``scale`` is stored as the ``(1 + scale)`` factor, zero at init."""

    def __init__(self, dim, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = zeros((dim,), device=device, dtype=dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = ones((dim,), device=device, dtype=dtype)
        self.bias = zeros((dim,), device=device, dtype=dtype)


def rmsnorm_specs():
    return {"scale": ("embed",)}


def layernorm_specs():
    return {"scale": ("embed",), "bias": ("embed",)}


def rmsnorm(p, x, *, eps=1e-6, upcast=True):
    dt = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p.scale.to(x.dtype))).to(dt)


def layernorm(p, x, *, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p.scale.to(x.dtype) + p.bias.to(x.dtype)).to(dt)


# ---------------------------------------------------------------- embedding
class Embedding(nn.Module):
    """The token table, shared with the output logits (tied)."""

    def __init__(self, vocab, dim, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        t = torch.empty((vocab, dim), dtype=dtype, device=device)
        if t.device.type != "meta":
            t.normal_(generator=generator)
        self.table = nn.Parameter(t, requires_grad=False)


def embed_specs():
    # "table_embed" (not "embed"): the table's d_model axis stays replicated
    return {"table": ("vocab", "table_embed")}


def embed_lookup(p, ids):
    return p.table[ids]


def embed_logits(p, x, *, softcap: float | None = None):
    logits = torch.einsum("...d,vd->...v", x, p.table.to(x.dtype))
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------- activations
def swiglu(gate, up):
    return F.silu(gate) * up


def geglu(gate, up):
    return F.gelu(gate, approximate="tanh") * up


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """Split-half RoPE in float32.  x: (..., seq, heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- views
def param_view(module: nn.Module, tensors):
    """``module``'s tree with each parameter replaced by ``tensors[name]``
    (``named_parameters`` names), as plain attributes, with
    ``nn.ModuleList``s as lists: what the apply functions read.  Nothing is
    copied, so tensors inside autograd (a cast of a master parameter)
    stay inside it, which a module's own ``nn.Parameter`` cannot."""
    def build(mod, prefix):
        view = types.SimpleNamespace(**{
            n: tensors[prefix + n]
            for n, _ in mod.named_parameters(recurse=False)})
        for n, child in mod.named_children():
            setattr(view, n, build(child, f"{prefix}{n}."))
        if isinstance(mod, nn.ModuleList):
            return [getattr(view, str(i)) for i in range(len(mod))]
        return view
    return build(module, "")


# ---------------------------------------------------------------- spec trees
def add_layer_axis_to_specs(specs):
    if isinstance(specs, dict):
        return {k: add_layer_axis_to_specs(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)
