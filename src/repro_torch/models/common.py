"""Building blocks of the model zoo (port of ``repro.models.common``).

Each block is an ``nn.Module`` that holds its parameters under the
reference's names (``RMSNorm.scale``, ``Embedding.table``, ...), and a
function applies it, as the reference's apply functions do its trees, so
the two packages can be held against each other function by function.
Parameters are float32 masters; a block casts a weight to the
activations' dtype where the reference does (``.to`` of a tensor already
in that dtype is free, which is what ``compute_copy`` relies on).

``specs`` trees give every parameter its logical axes, as data:
  layers, embed (d_model), q_heads, kv_heads, head_dim, mlp (d_ff), vocab,
  experts, table_embed, batch, kv_seq; the recurrent families add heads,
  act_in, heads_embed, lora and conv
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
import types

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt


# ---------------------------------------------------------------- init utils
_LEAF = threading.local()


def param(t) -> nn.Parameter:
    """``t`` as a parameter leaf (no gradient): every block makes its
    leaves through here, so an enclosing ``leaf_hook`` sees each one."""
    p = nn.Parameter(t, requires_grad=False)
    hook = getattr(_LEAF, "hook", None)
    return p if hook is None else hook(p)


@contextlib.contextmanager
def leaf_hook(fn):
    """Inside, each leaf a block makes is replaced by ``fn(leaf)`` as soon
    as it is made, before the next one is drawn (in this thread): the
    leaves come in the order the blocks make them, which is the same on
    the meta device as on any other."""
    prev = getattr(_LEAF, "hook", None)
    _LEAF.hook = fn
    try:
        yield
    finally:
        _LEAF.hook = prev


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
    return param(w)


def zeros(shape, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return param(torch.zeros(shape, dtype=dtype, device=device))


def ones(shape, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return param(torch.ones(shape, dtype=dtype, device=device))


def full(shape, value, *, device=None, dtype=torch.float32) -> nn.Parameter:
    return param(torch.full(shape, value, dtype=dtype, device=device))


def make_generator(generator, device) -> torch.Generator:
    """``generator`` itself, or a generator on ``device`` seeded with the
    int ``generator`` (0 for None)."""
    if isinstance(generator, torch.Generator):
        return generator
    seed = 0 if generator is None else int(generator)
    return torch.Generator(device=device).manual_seed(seed)


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
        self.table = param(t)


def embed_specs():
    # "table_embed" (not "embed"): the table's d_model axis stays replicated
    return {"table": ("vocab", "table_embed")}


def embed_lookup(p, ids):
    if _is_dtensor(p.table) or _is_dtensor(ids):
        return _embed_lookup_blocks(p.table, ids)
    return p.table[ids]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _embed_lookup_blocks(table, ids):
    """The lookup under a mesh, on each rank's own rows of ``ids`` against
    the whole table (gathered over its vocab shards): the gather
    ``table[ids]`` computes and its backward, whose sharding rule for the
    table's gradient some torch releases get wrong (a negative shard dim).
    Each rank's table gradient covers its own rows only, so it is a
    partial sum over the mesh dimensions the rows are split over."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding.rules import constrain, dtensor_of
    table = constrain(table, None, None)
    mesh = table.device_mesh
    if not _is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    grad = [Partial() if isinstance(pl, Shard) else Replicate()
            for pl in ids.placements]
    out = table.to_local(grad_placements=grad)[ids.to_local()]
    return dtensor_of(out, mesh, ids.placements,
                      tuple(ids.shape) + (table.shape[-1],))


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


def compute_copy(params: nn.Module, dtype, keep_float32):
    """``params`` (a zoo model, rebuilt on the meta device from its
    ``cfg``) with every weight cast to ``dtype`` once, except where
    ``keep_float32(module, name)``: the leaves the reference reads in
    float32 are shared with ``params``.  When every weight is already
    ``dtype``, ``params`` itself."""
    if all(p.dtype == dtype for p in params.parameters()):
        return params
    out = type(params)(params.cfg, device="meta")
    for (_, dst), (_, src) in zip(out.named_modules(), params.named_modules()):
        for name, t in src.named_parameters(recurse=False):
            keep = keep_float32(src, name)
            setattr(dst, name, nn.Parameter(t if keep else t.to(dtype),
                                            requires_grad=False))
    return out


def is_norm(module: nn.Module, name: str = "") -> bool:
    return isinstance(module, (RMSNorm, LayerNorm))


def remat(cfg, fn):
    """``fn`` under full activation checkpointing unless ``cfg.remat`` is
    "none": the reference's ``jax.checkpoint`` of a layer, which keeps its
    input and recomputes the rest in the backward pass."""
    if cfg.remat == "none":
        return fn
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def step_layers(layers, h, states, step):
    """``h, new = step(p, h, state)`` for each layer ``p`` on its slice of
    the stacked ``states`` (a dict of tensors with a leading layer axis),
    the new state written back into the slice in place."""
    for i, p in enumerate(layers):
        view = {k: a[i] for k, a in states.items()}
        h, new = step(p, h, view)
        for k, a in new.items():
            view[k].copy_(a)
    return h


# ---------------------------------------------------------------- spec trees
def add_layer_axis_to_specs(specs):
    if isinstance(specs, dict):
        return {k: add_layer_axis_to_specs(v) for k, v in specs.items()}
    return ("layers",) + tuple(specs)


def module_tree(mod: nn.Module, leaf):
    """``mod``'s parameters as a nested dict of ``leaf(parameter)``."""
    tree = {n: leaf(p) for n, p in mod.named_parameters(recurse=False)}
    for n, child in mod.named_children():
        tree[n] = module_tree(child, leaf)
    return tree


def shape_tree(mod: nn.Module, lead: tuple = ()):
    """``mod``'s parameter shapes, each behind the leading axes ``lead``:
    the reference's stacked tree of a list of identical layers."""
    return module_tree(mod, lambda p: tuple(lead) + tuple(p.shape))
