"""AdamW in plain PyTorch (port of ``repro.train.optimizer``), with:

  * float32 master params; the train step casts them to the compute dtype
  * global-norm clipping, decoupled weight decay, linear warmup and a
    cosine decay to ``min_lr_ratio`` of the peak

The arithmetic is the reference's, in its order (clip by
``min(1, clip / (gnorm + 1e-9))``, then the bias-corrected
``(mu / bc1) / (sqrt(nu / bc2) + eps) + wd · p`` times the lr), not
``torch.optim.AdamW``'s, whose update order and schedule differ.  The
update runs on whole lists of tensors through ``torch._foreach_*`` (the
same expression per element, fewer launches), and writes ``params``,
``mu`` and ``nu`` in place; it still returns ``(params, opt_state,
metrics)`` as the reference does.

A params tree is an ``nn.Module`` (its ``named_parameters``), a dict of
trees, or a list of them; ``mu`` and ``nu`` of a module are dicts keyed by
its parameter names, of any other tree the same tree.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.tree import named_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·peak (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _zeros_like_tree(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, nn.Module):
        return {n: torch.zeros_like(p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return type(tree)(_zeros_like_tree(v) for v in tree)


def init_state(params):
    device = named_leaves(params)[0][1].device
    return {"mu": _zeros_like_tree(params), "nu": _zeros_like_tree(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for _, x in named_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _aligned(params, other, what: str) -> list[torch.Tensor]:
    """``other``'s leaves in the order of ``params``' leaves."""
    want = [t for _, t in named_leaves(params)]
    got = named_leaves(other)
    if len(got) != len(want):
        raise ValueError(f"{what} has {len(got)} leaves, params {len(want)}")
    return [t for _, t in got]


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (params, opt_state, metrics); ``params``, ``mu`` and ``nu``
    are updated in place."""
    count = opt_state["count"] + 1
    flat_p = [p for _, p in named_leaves(params)]
    flat_g = _aligned(params, grads, "grads")
    mu = _aligned(params, opt_state["mu"], "mu")
    nu = _aligned(params, opt_state["nu"], "nu")
    gnorm = global_norm(flat_g)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        flat_g = torch._foreach_mul(flat_g, scale)
    flat_g = [g.to(torch.float32) for g in flat_g]
    lr = schedule(cfg, count)
    c = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c

    # mu = b1·mu + (1 - b1)·g;  nu = b2·nu + (1 - b2)·g·g
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(flat_g, 1 - cfg.b1))
    gg = torch._foreach_mul(flat_g, 1 - cfg.b2)
    torch._foreach_mul_(gg, flat_g)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, gg)
    del gg, flat_g
    # step = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd·p;  p = p - lr·step
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, den)
    del den
    torch._foreach_add_(step, torch._foreach_mul(flat_p, cfg.weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(flat_p, step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "count": count}, metrics
