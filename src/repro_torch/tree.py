"""Named leaves of the port's state trees: the one flattening order the
optimizer and the checkpointer share (the reference uses ``jax.tree``)."""
from __future__ import annotations

import torch
from torch import nn


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in a fixed order: a module's
    ``named_parameters``, a dict's keys in insertion order, a list's
    indices; the path's parts joined by "/" (a module's parameter names
    keep their dots: ``params/layers.0.attn.wq``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(f"{prefix}/{n}" if prefix else n, p)
                for n, p in tree.named_parameters()]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out.extend(named_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
