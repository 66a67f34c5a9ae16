"""Feed-forward blocks (port of ``repro.models.mlp``): gated (SwiGLU/GeGLU,
llama/gemma-style) and plain (GELU, whisper-style)."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.models import common as cm


class GatedMLP(nn.Module):
    def __init__(self, d_model, d_ff, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_gate = cm.dense_init((d_model, d_ff), (0,), **kw)
        self.w_up = cm.dense_init((d_model, d_ff), (0,), **kw)
        self.w_down = cm.dense_init((d_ff, d_model), (0,), **kw)


def gated_specs():
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


def gated_apply(p, x, *, activation="silu"):
    g = torch.einsum("bsd,df->bsf", x, p.w_gate.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p.w_up.to(x.dtype))
    act = cm.swiglu(g, u) if activation == "silu" else cm.geglu(g, u)
    return torch.einsum("bsf,fd->bsd", act, p.w_down.to(x.dtype))


class PlainMLP(nn.Module):
    def __init__(self, d_model, d_ff, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_in = cm.dense_init((d_model, d_ff), (0,), **kw)
        self.b_in = cm.zeros((d_ff,), device=device, dtype=dtype)
        self.w_out = cm.dense_init((d_ff, d_model), (0,), **kw)
        self.b_out = cm.zeros((d_model,), device=device, dtype=dtype)


def plain_specs():
    return {"w_in": ("embed", "mlp"), "b_in": ("mlp",),
            "w_out": ("mlp", "embed"), "b_out": ("embed",)}


def plain_apply(p, x):
    h = torch.einsum("bsd,df->bsf", x, p.w_in.to(x.dtype))
    h = F.gelu(h + p.b_in.to(x.dtype), approximate="tanh")
    return (torch.einsum("bsf,fd->bsd", h, p.w_out.to(x.dtype))
            + p.b_out.to(x.dtype))
