"""The fake-group side of ``tests/test_torch_dryrun.py``.

    python tests/_torch_dryrun_cells.py OUT.json

Runs in its own process, because a process group on the "fake" backend
(``launch.mesh.init_fake_process_group``) stays the default group until
destroyed.  On 4 fake ranks and the (2, 2) mesh: a dry-run cell of each
family's smoke config at each kind of ``SHAPES`` (train, prefill, decode,
long-context decode), the state bytes of one cell, the costs extrapolated
from reduced depths beside the full-depth trace, a train cell of 4
microbatches traced whole beside its 2- and 3-microbatch extrapolation,
and a sharded product's collectives.  On the (1, 4) mesh of the same 4
ranks, where internlm2's 2 kv heads do not divide "model" and its 4 q
heads do: its decode cell (the cache split by head_dim) with its
collective bytes by site and kind, and the FLOPs of ``attention._sdpa``
forward and backward on q, k and v laid out as ``_qkv`` lays them out,
beside the same without a mesh.  On the (4, 1) mesh of the same ranks
(the rows split 4 ways, which (1, 4) does not split): internlm2's train
cell with the gold-label gather on each rank's rows and left to
DTensor.  On 256 fake ranks (16 × 16) one cell;
on 1 fake rank the (1, 1) cell ``ONE_RANK`` that the test holds against
``roofline.analyze`` of the real step.  Writes one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

FAMILIES = ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b", "llava-next-mistral-7b",
            "rwkv6-1.6b", "zamba2-7b", "whisper-base"]
FAMILY_CHUNK = 16


def shapes():
    from repro_torch.configs.base import ShapeConfig
    return {"train": ShapeConfig("train_s", 32, 8, "train"),
            "prefill": ShapeConfig("prefill_s", 64, 4, "prefill"),
            "decode": ShapeConfig("decode_s", 64, 4, "decode"),
            # batch 1 < the 2 data ranks: the long-context rules
            "long": ShapeConfig("long_s", 128, 1, "decode")}


def smoke(arch, **kw):
    from repro_torch import configs
    cfg = configs.get_smoke_config(arch)
    if cfg.family in ("ssm", "hybrid", "audio"):
        kw.setdefault("ssm_chunk", FAMILY_CHUNK)
    return dataclasses.replace(cfg, **kw)


ONE_RANK = ("internlm2-1.8b", 2)     # (arch, microbatches) at train_s
SPLIT_ARCH = "internlm2-1.8b"        # 4 q heads, 2 kv heads, on (1, 4)


def split_decode(mesh):
    """The decode cell of SPLIT_ARCH on ``mesh``: its meta and its
    collective bytes by (site, kind)."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as roof
    from repro_torch.sharding.rules import current_site
    by = {}
    orig = roof.collective_bytes

    def booked(func, out):
        got = orig(func, out)
        if got is not None:
            site = by.setdefault(current_site() or "implicit", {})
            site[got[0]] = site.get(got[0], 0.0) + got[1]
        return got
    roof.collective_bytes = booked
    try:
        _, meta = dr.lower_cell(SPLIT_ARCH, shapes()["decode"], mesh,
                                cfg=smoke(SPLIT_ARCH))
    finally:
        roof.collective_bytes = orig
    return {"meta": meta, "by_site_kind": by}


def gold_gather(mesh):
    """SPLIT_ARCH's train cell on ``mesh`` (one microbatch), traced twice:
    with ``cross_entropy`` as it is, and with its gold-label gather left
    to DTensor (``torch.gather`` on the DTensors, the path before the
    gather ran on each rank's rows).  Each trace's step peak, FLOPs,
    collective bytes, and the largest storage an op made while autograd
    ran the gather's backward (``GatherBackward0``)."""
    import torch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as roof
    from repro_torch.train import train_step
    largest = [0]
    dispatch = roof.CostCounter.__torch_dispatch__

    def probed(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        node = torch._C._current_autograd_node()
        if node is not None and node.name() == "GatherBackward0":
            for t in roof._tensors(out):
                largest[0] = max(largest[0], t.untyped_storage().nbytes())
        return out

    def by_dtensor(logits, labels):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]

    out = {}
    local = train_step._gold_on_local_rows
    roof.CostCounter.__torch_dispatch__ = probed
    try:
        for path, gold in (("local_rows", local), ("dtensor", by_dtensor)):
            train_step._gold_on_local_rows = gold
            largest[0] = 0
            _, meta = dr.lower_cell(SPLIT_ARCH, shapes()["train"], mesh,
                                    cfg=smoke(SPLIT_ARCH), microbatches=1)
            out[path] = {"peak": meta["step_peak_bytes_per_dev"],
                         "flops": meta["flops_per_dev"],
                         "coll": meta["coll_bytes_per_dev"],
                         "gather_grad_largest": largest[0]}
    finally:
        roof.CostCounter.__torch_dispatch__ = dispatch
        train_step._gold_on_local_rows = local
    return out


def attention_flops(mesh, b, s):
    """FLOPs of SPLIT_ARCH's ``attention._sdpa`` (causal, forward and the
    gradients of q, k and v), with q, k and v pinned as ``_qkv`` pins
    them under ``mesh`` (None: plain tensors)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline as roof
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.sharding.rules import constrain
    acfg = transformer._attn_cfg(smoke(SPLIT_ARCH))
    h, kh, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    counter = roof.CostCounter()
    with mesh_lib.fake_tensors(), mesh_lib.use_mesh(mesh):
        leaves = [torch.empty(b, s, n, hd, requires_grad=True)
                  for n in (h, kh, kh)]
        q = constrain(leaves[0], "batch", None, "q_heads", None)
        k, v = (constrain(t, "batch", None, "kv_heads", None)
                for t in leaves[1:])
        with counter:
            out = attn._sdpa(acfg, q, k, v, attn.causal_mask(s, s))
            torch.autograd.grad(out, leaves, torch.ones_like(out))
    return counter.flops


def main(path):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import roofline as roof
    out = {"cells": {}}
    S = shapes()

    mesh_lib.init_fake_process_group(4)
    try:
        mesh = mesh_lib.make_host_mesh(data=2, model=2, device_type="cpu")
        for arch in FAMILIES:
            for kind, shape in S.items():
                key = f"{arch}/{kind}"
                try:
                    _, meta = dr.lower_cell(arch, shape, mesh,
                                            cfg=smoke(arch), microbatches=2)
                    meta["status"] = "ok"
                except Exception as e:  # noqa: BLE001 — the test reports it
                    meta = {"status": "error",
                            "error": traceback.format_exc()[-3000:]}
                out["cells"][key] = meta
        # full-depth trace against the reduced-depth extrapolation
        deep = smoke("internlm2-1.8b", n_layers=6)
        r_full, _ = dr.lower_cell("internlm2-1.8b", S["train"], mesh,
                                  cfg=deep, microbatches=1)
        r_ext = dr.extrapolated_costs("internlm2-1.8b", S["train"], mesh,
                                      microbatches=1, cfg=deep)
        out["extrapolated"] = {
            "full": [r_full.flops, r_full.bytes_accessed,
                     r_full.coll_breakdown],
            "extrapolated": [r_ext.flops, r_ext.bytes_accessed,
                             r_ext.coll_breakdown]}
        # 4 microbatches: the whole trace (by hand, through the private
        # tracer) against lower_cell's 2- and 3-microbatch extrapolation
        cfg = smoke("internlm2-1.8b")
        from repro_torch.models import get_model
        whole, _, _ = dr._traced(get_model(cfg), S["train"], mesh, None, 4)
        r4, meta4 = dr.lower_cell("internlm2-1.8b", S["train"], mesh,
                                  cfg=cfg, microbatches=4)
        out["microbatches"] = {
            "whole": [whole.flops, whole.op_bytes, whole.coll],
            "extrapolated": [r4.flops, r4.bytes_accessed, r4.coll_breakdown],
            "traced": meta4["traced_microbatches"]}
        # a sharded product's collectives and FLOPs
        with mesh_lib.fake_tensors():
            a = DTensor.from_local(torch.empty(8, 8), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            b = DTensor.from_local(torch.empty(8, 12), mesh,
                                   [Replicate(), Shard(0)], run_check=False)
            x = DTensor.from_local(torch.empty(4, 16), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            c = roof.CostCounter()
            with c:
                p = a @ b                              # (8, 12), Partial
                p.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Shard(0)])
                x.redistribute(mesh, [Replicate(), Replicate()])
            out["matmul"] = {"flops": c.flops, "coll": c.coll,
                             "partial": isinstance(p.placements[1], Partial)}
        # the kv heads do not divide "model": attention on q-head blocks
        # and decode on a head_dim-split cache
        narrow = mesh_lib.make_host_mesh(data=1, model=4, device_type="cpu")
        out["split_decode"] = split_decode(narrow)
        b, s = shapes()["train"].global_batch, shapes()["train"].seq_len
        out["attention_flops"] = {"sharded": attention_flops(narrow, b, s),
                                  "unsharded": attention_flops(None, b, s)}
        # the gold-label gather's backward on the data axis: (1, 4) splits
        # no rows, so the same 4 ranks as (4, 1)
        rows = mesh_lib.make_host_mesh(data=4, model=1, device_type="cpu")
        out["gold_gather"] = gold_gather(rows)
    finally:
        dist.destroy_process_group()

    mesh_lib.init_fake_process_group(256)
    try:
        mesh = mesh_lib.make_production_mesh(device_type="cpu")
        _, meta = dr.lower_cell("internlm2-1.8b", S["train"], mesh,
                                cfg=smoke("internlm2-1.8b"), microbatches=2)
        out["production"] = meta
    finally:
        dist.destroy_process_group()

    mesh_lib.init_fake_process_group(1)
    try:
        mesh = mesh_lib.make_host_mesh(data=1, model=1, device_type="cpu")
        arch, m = ONE_RANK
        _, meta = dr.lower_cell(arch, S["train"], mesh, cfg=smoke(arch),
                                microbatches=m)
        out["one_rank"] = meta
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f, default=str)


if __name__ == "__main__":
    import logging
    logging.disable(logging.WARNING)   # DTensor's per-op advice
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    main(sys.argv[1])
