"""Checkpointing without external deps (port of
``repro.checkpoint.checkpointer``): npz shards + a JSON index.

Layout (one directory per step):
    ckpt_dir/step_00000100/
        index.json           # leaf keys, shapes, dtypes, step, metadata
        host_000.npz         # this host's leaves (flat key -> array)
        COMMITTED            # atomic commit marker (written last)

The reference writes its index with msgpack, which the card's machine
does not have; the index here is stdlib ``json`` with the same content.

Fault-tolerance properties:
  * atomic: writes go to step_XXX.tmp/, then are renamed + COMMITTED
    marker; restore ignores uncommitted directories (crash-consistent)
  * self-describing: the index carries every leaf's key, shape and dtype

Leaf keys are "/"-joined paths through dicts and lists; a module's
parameters are keyed by their ``named_parameters`` names (the train state
gives ``params/layers.0.attn.wq``, ``opt/mu/layers.0.attn.wq``,
``opt/count``, ``step``).  bfloat16 leaves are stored as their 16-bit
patterns (npz has no bfloat16).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.tree import named_leaves

COMMIT_MARKER = "COMMITTED"
INDEX = "index.json"


def save(ckpt_dir: str, step: int, tree, *, host_id: int = 0,
         extra_metadata: dict | None = None) -> str:
    """Write one checkpoint atomically. Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    index = {"keys": [], "step": step, "extra": extra_metadata or {}}
    for key, leaf in named_leaves(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
            dtype = "bfloat16"
        else:
            arrays[key] = t.numpy()
            dtype = str(arrays[key].dtype)
        index["keys"].append({"key": key, "shape": list(t.shape),
                              "dtype": dtype})
    np.savez(os.path.join(tmp, f"host_{host_id:03d}.npz"), **arrays)
    with open(os.path.join(tmp, INDEX), "w") as f:
        json.dump(index, f)
    # atomic commit: rename then marker
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(final, COMMIT_MARKER), "w") as f:
        f.write("ok")
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest committed step (ignores torn writes)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, COMMIT_MARKER)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, host_id: int = 0,
            device=None):
    """Restore into the structure of ``like_tree`` (shapes verified).

    Returns a new tree of dicts and lists; a module in ``like_tree`` gets
    the checkpoint's tensors as its parameters in place (so a module on
    the meta device is materialized) and is returned as it is.  Each
    tensor goes to its ``like_tree`` leaf's device, or to ``device``
    (``None`` means CUDA) where that leaf is on the meta device.  Raises
    ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for a
    shape that differs."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(final, COMMIT_MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {final}")
    with open(os.path.join(final, INDEX)) as f:
        index = json.load(f)
    by_key = {meta["key"]: meta for meta in index["keys"]}
    with np.load(os.path.join(final, f"host_{host_id:03d}.npz")) as data:

        def load(key, leaf):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            meta = by_key[key]
            if tuple(meta["shape"]) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {meta['shape']} "
                                 f"!= {tuple(leaf.shape)}")
            arr = data[key]
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            dev = (resolve_device(device) if leaf.device.type == "meta"
                   else leaf.device)
            return t.to(dev)

        def build(tree, prefix):
            def path(k):
                return f"{prefix}/{k}" if prefix else str(k)
            if isinstance(tree, torch.Tensor):
                return load(prefix, tree)
            if isinstance(tree, nn.Module):
                for n, p in list(tree.named_parameters()):
                    mod_path, _, leaf = n.rpartition(".")
                    setattr(tree.get_submodule(mod_path), leaf,
                            nn.Parameter(load(path(n), p),
                                         requires_grad=p.requires_grad))
                return tree
            if isinstance(tree, dict):
                return {k: build(v, path(k)) for k, v in tree.items()}
            return type(tree)(build(v, path(i)) for i, v in enumerate(tree))

        return build(like_tree, "")


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest `keep` committed checkpoints + any tmp."""
    if not os.path.isdir(ckpt_dir):
        return
    committed = []
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if name.endswith(".tmp"):
            shutil.rmtree(path, ignore_errors=True)
        elif name.startswith("step_"):
            if os.path.exists(os.path.join(path, COMMIT_MARKER)):
                committed.append(path)
            else:
                shutil.rmtree(path, ignore_errors=True)
    for path in committed[:-keep]:
        shutil.rmtree(path, ignore_errors=True)
