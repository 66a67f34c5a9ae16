"""Gradient compression for data parallelism across slow links (port of
``repro.train.compression``).

int8 block-quantized all-reduce with error feedback (1-bit-Adam-family
trick, arXiv:1812.07478 lineage): each data-parallel rank quantizes its
local gradient to int8 with a per-block float32 scale, all-reduces (sum)
the payload, and keeps the quantization residual locally, adding it back
into the next step's gradient: unbiased over time, 4× less traffic than
float32.

The reference runs inside ``shard_map`` over a mesh axis name; here the
all-reduce takes a ``torch.distributed`` process group.  The pure
functions are plain tensor code on any device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import engine

BLOCK = 256


def _pad_to_block(x):
    n = x.numel()
    pad = (-n) % BLOCK
    flat = torch.cat([x.reshape(-1), x.new_zeros((pad,))])
    return flat.reshape(-1, BLOCK), n


def quantize(x: torch.Tensor):
    """x (any shape, float) -> (q int8 (nblk, BLOCK), scale f32 (nblk, 1))."""
    blocks, _ = _pad_to_block(x.to(torch.float32))
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compress_residual(x: torch.Tensor, residual: torch.Tensor):
    """Error-feedback step: quantize (x + residual), return the payload and
    the new residual = (x + residual) - dequant(payload)."""
    target = x.to(torch.float32) + residual
    q, scale = quantize(target)
    deq = dequantize(q, scale, x.shape)
    return (q, scale), target - deq


def allreduce_compressed(x: torch.Tensor, residual: torch.Tensor,
                         group=None):
    """Error-feedback int8 all-reduce-mean of ``x`` over ``group`` (the
    default group when ``None``).  Returns (mean, new residual).

    One ``all_reduce`` sums the dequantized blocks in float32, as the
    reference's ``psum`` does; ``engine.collective_counter`` records it
    with the wire format's bytes (the int8 payload and its float32
    scales), the size the reference's accounting models."""
    (q, scale), new_residual = compress_residual(x, residual)
    contrib = dequantize(q, scale, x.shape)
    engine.record_collective("sum", q.numel() * q.element_size()
                             + scale.numel() * scale.element_size())
    dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
    return contrib / dist.get_world_size(group), new_residual


def init_residuals(tree):
    """Float32 zeros shaped as each tensor of a dict/list tree."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    if isinstance(tree, dict):
        return {k: init_residuals(v) for k, v in tree.items()}
    return type(tree)(init_residuals(v) for v in tree)


def tree_allreduce_compressed(grads, residuals, group=None):
    """``allreduce_compressed`` over every tensor of a dict/list tree;
    returns (mean tree, residual tree)."""
    if isinstance(grads, torch.Tensor):
        return allreduce_compressed(grads, residuals, group)
    if isinstance(grads, dict):
        out = {k: tree_allreduce_compressed(grads[k], residuals[k], group)
               for k in grads}
        return ({k: o[0] for k, o in out.items()},
                {k: o[1] for k, o in out.items()})
    out = [tree_allreduce_compressed(g, r, group)
           for g, r in zip(grads, residuals)]
    return (type(grads)(o[0] for o in out), type(grads)(o[1] for o in out))
