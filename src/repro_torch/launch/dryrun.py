"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(arch × shape × mesh) cell on a fake 256- or 512-rank mesh and read its
per-rank costs, with no real allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

This process plays rank 0 of a process group on the "fake" backend
(``launch.mesh.init_fake_process_group``), whose collectives return at
once, and runs one train step, prefill or decode of the cell under
``FakeTensorMode``, with the parameters, state and batch laid out as the
reference's ``lower_cell`` lays them out: float32 masters and AdamW
moments for train cells, bf16 serving parameters otherwise, the decode
and long-context rule overrides (``_overrides_for``), the per-arch
microbatch counts, and the prefill cache laid out like decode.  Every
DTensor op runs its local op on rank 0's blocks, so the counts are per
rank: FLOPs by ``torch.utils.flop_counter``'s formulas, collective bytes
by kind from the traced collectives, and op bytes (each counted op's
inputs and outputs, no fusion) as ``bytes_per_dev``
(``roofline.CostCounter``).  Memory per rank: ``state_bytes_per_dev``, the
local blocks of the parameters, moments and decode state (exact), and
``peak_memory_gb``, that plus the batch plus the most bytes the step's own
storages held at once in the eager op order (an estimate: it is not the
allocator's schedule).

The reference compiles each cell once with its layer scan counted once
(``--costs loop``) and gets exact costs from unrolled reduced-depth
compiles extrapolated in the layer count (``--costs exact``).  An eager
trace runs every layer, so its full-depth count is already exact; the
reduced points are kept (``reduced_points``, ``extrapolated_costs``) and
agree with it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, shapes_for
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as roof
from repro_torch.models import get_model
from repro_torch.sharding import rules
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train_step import (abstract_train_state, shard_batch,
                                          train_state_specs)

MICROBATCHES = int(os.environ.get("REPRO_MICROBATCHES", "8"))
# per-arch grad-accumulation overrides (the reference's memory-floor tuning)
ARCH_MICROBATCHES = {"dbrx-132b": 16}


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _overrides_for(shape: ShapeConfig, mesh):
    if shape.kind != "decode":
        return None
    if shape.global_batch < _axes_size(mesh, rules.data_axes(mesh)):
        return rules.LONG_CONTEXT_OVERRIDES
    return rules.DECODE_OVERRIDES


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _fake_like(tree, dtype_of=None):
    """``tree`` (meta tensors, modules on the meta device, dicts, host
    scalars) with every tensor a fake CPU tensor of its shape; a module's
    parameters are replaced in place.  ``dtype_of(t)`` picks a dtype."""
    def one(t):
        return torch.empty(t.shape, dtype=dtype_of(t) if dtype_of
                           else t.dtype)
    if isinstance(tree, torch.nn.Module):
        for n, p in list(tree.named_parameters()):
            mod, _, leaf = n.rpartition(".")
            setattr(tree.get_submodule(mod), leaf,
                    torch.nn.Parameter(one(p), requires_grad=False))
        return tree
    if isinstance(tree, torch.Tensor):
        return one(tree)
    if isinstance(tree, dict):
        return {k: _fake_like(v, dtype_of) for k, v in tree.items()}
    return tree


def _serve_dtype(t):
    """Serving reads bf16 weights (half the weight reads and memory of
    the float32 training masters)."""
    return torch.bfloat16 if t.dtype.is_floating_point else t.dtype


def _local_bytes(tree) -> int:
    """Σ of this rank's block bytes over the tensors of ``tree``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _shape_of(shape) -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


def _traced(model, shape, mesh, overrides, microbatches):
    """One traced step of the cell: (the ``CostCounter``, the state's and
    the batch's local bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = roof.CostCounter(track_memory=True)
    with mesh_lib.fake_tensors():
        in_specs = _fake_like(model.input_specs(shape))
        if shape.kind == "train":
            tc = TrainConfig(microbatches=microbatches)
            state = _fake_like(abstract_train_state(model))
            sh = rules.tree_shardings(mesh, train_state_specs(model), state,
                                      overrides=overrides)
            state = rules.distribute_tree(state, sh)
            batch = shard_batch(in_specs, mesh, microbatches)
            batch_bytes = _local_bytes(batch)
            state_bytes = _local_bytes(state)
            step = make_train_step(model, tc)
            with counter:
                step(state, batch)
            return counter, state_bytes, batch_bytes
        params = _fake_like(model.abstract_params(), _serve_dtype)
        psh = rules.tree_shardings(mesh, model.param_specs(), params,
                                   overrides=overrides)
        params = rules.distribute_tree(params, psh)
        state_bytes = _local_bytes(params)
        ctx = mesh_lib.use_mesh(mesh, state_overrides=overrides)
        if shape.kind == "prefill":
            batch = shard_batch(in_specs, mesh)
            with ctx, implicit_replication(), counter:
                _, out_state = model.prefill(params, batch, shape.seq_len)
            return (counter, state_bytes + _local_bytes(out_state),
                    _local_bytes(batch))
        dstate = in_specs["state"]
        ssh = rules.tree_shardings(mesh, model.decode_state_specs(), dstate,
                                   overrides=overrides)
        dstate = rules.distribute_tree(dstate, ssh)
        token = shard_batch({"token": in_specs["token"]}, mesh)["token"]
        with ctx, implicit_replication(), counter:
            model.decode_step(params, token, dstate)
        return counter, state_bytes + _local_bytes(dstate), \
            _local_bytes(token)


def lower_cell(arch: str, shape_name, mesh, *, verbose: bool = False,
               cfg=None, microbatches: int | None = None):
    """Trace one cell on ``mesh`` (of the default fake group).  Returns
    (its ``Roofline``, meta).  ``shape_name`` may be a ``ShapeConfig`` of
    its own.

    A train cell of more than 3 microbatches is traced at 2 and 3 of them,
    each with the rows one of its microbatches has (a batch of 2·B/m and
    3·B/m rows): the microbatches run identical bodies, so its costs are
    c(2) + (m - 2)·(c(3) - c(2)) exactly, and its peak is the 3-microbatch
    trace's (the same accumulators and one microbatch's activations)."""
    cfg = cfg or configs.get_config(arch)
    shape = _shape_of(shape_name)
    model = get_model(cfg)
    overrides = _overrides_for(shape, mesh)
    if microbatches is None:
        microbatches = ARCH_MICROBATCHES.get(arch, MICROBATCHES)

    t0 = time.time()
    m = microbatches if shape.kind == "train" else 1
    if m <= 3:
        counter, state_bytes, batch_bytes = _traced(model, shape, mesh,
                                                    overrides, m)
        flops, op_bytes, coll = counter.flops, counter.op_bytes, counter.coll
        by_site = counter.coll_by_site
        traced = [m]
    else:
        if shape.global_batch % m:
            raise ValueError(f"{shape.global_batch} rows do not split into "
                             f"{m} microbatches")
        rows = shape.global_batch // m
        c2, state_bytes, b2 = _traced(
            model, dataclasses.replace(shape, global_batch=2 * rows), mesh,
            overrides, 2)
        counter, _, b3 = _traced(
            model, dataclasses.replace(shape, global_batch=3 * rows), mesh,
            overrides, 3)
        batch_bytes = b2 + (m - 2) * (b3 - b2)
        flops = c2.flops + (m - 2) * (counter.flops - c2.flops)
        op_bytes = c2.op_bytes + (m - 2) * (counter.op_bytes - c2.op_bytes)
        coll, by_site = ({k: c2_d.get(k, 0.0)
                          + (m - 2) * (c3_d.get(k, 0.0) - c2_d.get(k, 0.0))
                          for k in set(c2_d) | set(c3_d)}
                         for c2_d, c3_d in ((c2.coll, counter.coll),
                                            (c2.coll_by_site,
                                             counter.coll_by_site)))
        traced = [2, 3]
    t_lower = time.time() - t0

    peak = state_bytes + batch_bytes + counter.peak_bytes
    r = roof.Roofline(flops=float(flops), bytes_accessed=float(op_bytes),
                      coll_bytes=sum(coll.values()),
                      coll_breakdown=dict(coll), peak_memory=int(peak))
    n_tokens = model.batch_tokens(shape)
    mf = roof.model_flops(cfg, shape, n_tokens)
    n_dev = mesh.size()
    meta = {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mesh),
        "n_devices": n_dev,
        "tokens_per_step": n_tokens,
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / max(r.flops, 1.0),
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "state_bytes_per_dev": state_bytes,
        "step_peak_bytes_per_dev": counter.peak_bytes,
        "microbatches": m, "traced_microbatches": traced,
        "coll_by_site": dict(sorted(by_site.items())),
        **r.summary(),
    }
    if verbose:
        print(f"  memory: state={state_bytes/1e9:.2f}GB "
              f"batch={batch_bytes/1e9:.2f}GB "
              f"step={counter.peak_bytes/1e9:.2f}GB", file=sys.stderr)
    return r, meta


# ------------------------------------------------------------ exact costs
def reduced_points(cfg):
    """Two reduced-depth configs (k_lo, cfg_lo), (k_hi, cfg_hi) + k_full such
    that every cost term is linear in k (identical per-group bodies):
        cost(full) = c_lo + (k_full - k_lo) · (c_hi - c_lo)/(k_hi - k_lo)
    k counts layer groups.  zamba2 keeps its tail in both points so the
    tail's contribution lands in the constant term."""
    if cfg.family == "hybrid":
        tail = cfg.n_layers % cfg.attn_every
        k_full = cfg.n_layers // cfg.attn_every
        lo = dataclasses.replace(cfg, n_layers=2 * cfg.attn_every + tail)
        hi = dataclasses.replace(cfg, n_layers=4 * cfg.attn_every + tail)
        return (2, lo), (4, hi), k_full
    if cfg.family == "audio":
        k_full = cfg.n_enc_layers
        assert cfg.n_enc_layers == cfg.n_dec_layers
        lo = dataclasses.replace(cfg, n_enc_layers=2, n_dec_layers=2,
                                 n_layers=4)
        hi = dataclasses.replace(cfg, n_enc_layers=4, n_dec_layers=4,
                                 n_layers=8)
        return (2, lo), (4, hi), k_full
    from repro_torch.models.transformer import group_size
    g = group_size(cfg) if cfg.family in ("dense", "moe", "vlm") else 1
    k_full = cfg.n_layers // g
    lo = dataclasses.replace(cfg, n_layers=2 * g)
    hi = dataclasses.replace(cfg, n_layers=4 * g)
    return (2, lo), (4, hi), k_full


def extrapolated_costs(arch: str, shape_name, mesh,
                       microbatches: int | None = None, *, cfg=None):
    """FLOPs / op bytes / collective bytes extrapolated from two reduced
    depths — and, for train cells with gradient accumulation, bilinearly in
    (groups, microbatches): every cost term is α + β·L + γ·m + δ·L·m,
    solved from 4 points.  An eager trace counts every layer, so this
    equals the full-depth count; it is kept as the reference's check.
    ``cfg`` (default the arch's published config) is the full-depth one."""
    cfg = cfg or configs.get_config(arch)
    shape = _shape_of(shape_name)
    if microbatches is None:
        microbatches = MICROBATCHES
    (k_lo, cfg_lo), (k_hi, cfg_hi), k_full = reduced_points(cfg)
    m_target = microbatches if shape.kind == "train" else 1

    def run(c, m):
        return lower_cell(arch, shape, mesh, cfg=c, microbatches=m)[0]

    r_ll = run(cfg_lo, 1)
    r_hl = run(cfg_hi, 1)
    if m_target > 1:
        r_lm = run(cfg_lo, 2)
        r_hm = run(cfg_hi, 2)

    dk = (k_full - k_lo) / (k_hi - k_lo)

    def combine(get):
        at_m1 = get(r_ll) + dk * (get(r_hl) - get(r_ll))
        if m_target == 1:
            return at_m1
        dm_lo = get(r_lm) - get(r_ll)          # m: 1 -> 2 at k_lo
        dm_hi = get(r_hm) - get(r_hl)
        dm_at_k = dm_lo + dk * (dm_hi - dm_lo)
        return at_m1 + (m_target - 1) * dm_at_k

    kinds = set(r_ll.coll_breakdown) | set(r_hl.coll_breakdown)
    if m_target > 1:
        kinds |= set(r_lm.coll_breakdown) | set(r_hm.coll_breakdown)
    coll = {k: combine(lambda r, k=k: r.coll_breakdown.get(k, 0.0))
            for k in kinds}
    return roof.Roofline(
        flops=combine(lambda r: r.flops),
        bytes_accessed=combine(lambda r: r.bytes_accessed),
        coll_bytes=sum(coll.values()),
        coll_breakdown=coll,
        peak_memory=0,  # memory comes from the full-depth trace
    )


def analyze_cell(arch: str, shape_name, mesh, *, exact: bool = True,
                 verbose: bool = False):
    """Full-depth trace (validity + memory + costs) and, with ``exact``,
    the reduced-depth extrapolation's costs (at microbatches=1, as the
    reference takes them)."""
    r_loop, meta = lower_cell(arch, shape_name, mesh, verbose=verbose)
    if not exact:
        return meta
    r = extrapolated_costs(arch, shape_name, mesh, microbatches=1)
    cfg = configs.get_config(arch)
    shape = _shape_of(shape_name)
    model = get_model(cfg)
    mf_dev = roof.model_flops(cfg, shape, model.batch_tokens(shape)) \
        / mesh.size()
    meta.update({
        "flops_per_dev": r.flops,
        "bytes_per_dev": r.bytes_accessed,
        "coll_bytes_per_dev": r.coll_bytes,
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "coll_breakdown": r.coll_breakdown,
        "useful_flops_ratio": mf_dev / max(r.flops, 1.0),
        "loop_counted_flops": r_loop.flops,   # the full-depth trace's
    })
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    meta["dominant"] = max(terms, key=terms.get)
    meta["step_s"] = max(terms.values())
    return meta


def run_cells(cells, multi_pod_modes, out_path=None, verbose=False,
              exact=True):
    """Each cell on a fake group of the mode's size; a failed cell is
    recorded as ``status: error`` and the others go on."""
    import torch.distributed as dist
    results = []
    for mp in multi_pod_modes:
        mesh_lib.init_fake_process_group(mesh_lib.required_devices(mp))
        try:
            mesh = mesh_lib.make_production_mesh(multi_pod=mp,
                                                 device_type="cpu")
            for arch, shape_name in cells:
                tag = f"{arch} × {shape_name} × {_mesh_name(mesh)}"
                print(f"[dryrun] {tag} ...", file=sys.stderr, flush=True)
                try:
                    meta = analyze_cell(arch, shape_name, mesh, exact=exact,
                                        verbose=verbose)
                    meta["status"] = "ok"
                    print(f"[dryrun] {tag}: OK "
                          f"compute={meta['compute_s']:.4f}s "
                          f"memory={meta['memory_s']:.4f}s "
                          f"coll={meta['collective_s']:.4f}s "
                          f"dominant={meta['dominant']} "
                          f"state={meta['state_bytes_per_dev']/1e9:.2f}GB "
                          f"peak={meta['peak_memory_gb']:.2f}GB "
                          f"(trace {meta['lower_s']}s)",
                          file=sys.stderr, flush=True)
                except Exception as e:  # noqa: BLE001 — recorded; exit 1
                    meta = {"arch": arch, "shape": shape_name,
                            "mesh": _mesh_name(mesh), "status": "error",
                            "error": f"{type(e).__name__}: {e}"}
                    print(f"[dryrun] {tag}: FAIL {meta['error']}",
                          file=sys.stderr, flush=True)
                    if verbose:
                        traceback.print_exc()
                results.append(meta)
                if out_path:  # incremental write (cells are slow)
                    with open(out_path, "w") as f:
                        json.dump(results, f, indent=1, default=str)
        finally:
            dist.destroy_process_group()
    if out_path:
        print(f"[dryrun] wrote {out_path}", file=sys.stderr)
    return results


def all_cells():
    cells = []
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--costs", choices=["exact", "loop"], default="exact",
                    help="exact = reduced-depth extrapolation as well; "
                         "loop = the full-depth trace alone (which an "
                         "eager trace already counts exactly)")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        cfg = configs.get_config(args.arch)
        shapes = ([args.shape] if args.shape
                  else [s.name for s in shapes_for(cfg)])
        cells = [(args.arch, s) for s in shapes]
    mp = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    results = run_cells(cells, mp, args.out, args.verbose,
                        exact=args.costs == "exact")
    bad = [r for r in results if r["status"] != "ok"]
    print(json.dumps(results, indent=1, default=str))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
