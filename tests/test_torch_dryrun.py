"""The dry run (``repro_torch.launch.dryrun``) on fake process groups.

The fake group runs in a subprocess (``tests/_torch_dryrun_cells.py``), as
it stays this process's default group until destroyed.  Held here:

* a smoke cell of each family (dense, MoE, VLM, rwkv6, zamba2, whisper) at
  each kind (train, prefill, decode, long-context decode) on a (2, 2)
  mesh, and one on 16 × 16, has the reference's ``meta`` keys, and its
  collective bytes by site add up to its bytes by kind;
* the state bytes per rank of the train cell equal the sum of the local
  block bytes worked out here from the specs (parameters, mu and nu at
  float32, count and step replicated);
* the costs extrapolated from two reduced depths equal the full-depth
  trace (an eager trace counts every layer), and a 4-microbatch train cell
  extrapolated from its 2- and 3-microbatch traces equals its whole trace;
* a sharded product's collective bytes by kind and FLOPs equal a hand
  count;
* where the kv heads do not divide "model" (internlm2's smoke config on
  (1, 4)): attention's products on q-head blocks cost a quarter of the
  unsharded model's, as counted by hand, and a decode cell moves no block
  of its head_dim-split cache, all-reducing the partial logits instead
  (by hand);
* the gold-label gather's backward (internlm2's smoke train cell on
  (4, 1)) makes its zeros at the rank's rows, not the global batch's, and
  the step's peak falls by the hand count;
* a (1, 1) dry run's FLOPs equal ``roofline.analyze`` of the real step on
  the same config and batch shape, and its state bytes the real state's;
* ``analyze`` books a plain c10d all-reduce, and the ambient mesh of
  ``use_mesh`` is each thread's own.
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import roofline as roof
from repro_torch.models import get_model
from repro_torch.sharding import rules
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.train_step import train_state_specs

ROOT = Path(__file__).resolve().parent.parent
HELPER = ROOT / "tests" / "_torch_dryrun_cells.py"
_spec = importlib.util.spec_from_file_location("_torch_dryrun_cells", HELPER)
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)
CHILD_TIMEOUT = 900

# the reference's analyze_cell meta keys (lower_cell's and the summary's;
# the exact-cost keys are added by analyze_cell in both packages)
META_KEYS = {"arch", "shape", "mesh", "n_devices", "tokens_per_step",
             "model_flops_total", "model_flops_per_dev",
             "useful_flops_ratio", "lower_s", "compile_s", "flops_per_dev",
             "bytes_per_dev", "coll_bytes_per_dev", "compute_s", "memory_s",
             "collective_s", "dominant", "step_s", "peak_memory_gb",
             "coll_breakdown"}


@pytest.fixture(scope="module")
def cells():
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
        env["OMP_NUM_THREADS"] = "1"
        out = subprocess.run([sys.executable, str(HELPER), f"{d}/out.json"],
                             env=env, capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT)
        assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
        with open(f"{d}/out.json") as f:
            return json.load(f)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "long"])
@pytest.mark.parametrize("arch", C.FAMILIES)
def test_every_family_and_kind_traces(cells, arch, kind):
    meta = cells["cells"][f"{arch}/{kind}"]
    assert meta["status"] == "ok", meta.get("error")
    assert META_KEYS <= set(meta), META_KEYS - set(meta)
    assert meta["mesh"] == "2x2" and meta["n_devices"] == 4
    assert meta["flops_per_dev"] > 0 and meta["state_bytes_per_dev"] > 0
    assert meta["peak_memory_gb"] * 1e9 >= meta["state_bytes_per_dev"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "long"])
def test_collectives_are_booked_to_their_sites(cells, kind):
    """Every collective's bytes go to the ``constrain`` site that issued
    it or to "implicit" (DTensor's own, inside an op): the sites add up to
    the kinds."""
    for arch in C.FAMILIES:
        meta = cells["cells"][f"{arch}/{kind}"]
        by_site = sum(meta["coll_by_site"].values())
        assert by_site == pytest.approx(meta["coll_bytes_per_dev"],
                                        rel=1e-12, abs=0)


def test_production_mesh_cell(cells):
    meta = cells["production"]
    assert META_KEYS <= set(meta)
    assert meta["mesh"] == "16x16" and meta["n_devices"] == 256


def _by_hand_state_bytes(cfg, mesh_shape):
    """Σ of one rank's block bytes of a train state: each parameter's
    elements divided by the mesh axes its spec shards it over, 3 float32
    copies (the master, mu, nu), then count and step (int32, replicated)."""
    class PortMesh:
        mesh_dim_names = tuple(mesh_shape)
        shape = tuple(mesh_shape.values())
    model = get_model(cfg)
    params = model.abstract_params()
    sh = rules.tree_shardings(PortMesh(), model.param_specs(), params)
    total = 0
    for n, p in params.named_parameters():
        local = p.numel()
        for entry in sh[n].spec:
            for ax in (() if entry is None else
                       entry if isinstance(entry, tuple) else (entry,)):
                local //= mesh_shape[ax]
        total += 3 * 4 * local
    return total + 2 * 4


def test_state_bytes_per_rank_by_hand(cells):
    meta = cells["cells"]["internlm2-1.8b/train"]
    want = _by_hand_state_bytes(C.smoke("internlm2-1.8b"),
                                {"data": 2, "model": 2})
    assert meta["state_bytes_per_dev"] == want


def test_extrapolated_costs_equal_the_full_depth_trace(cells):
    full = cells["extrapolated"]["full"]
    ext = cells["extrapolated"]["extrapolated"]
    assert ext[0] == full[0] and ext[1] == full[1]
    assert ext[2] == full[2]


def test_microbatch_extrapolation_equals_the_whole_trace(cells):
    mb = cells["microbatches"]
    assert mb["traced"] == [2, 3]
    whole, ext = mb["whole"], mb["extrapolated"]
    assert ext[0] == whole[0] and ext[1] == whole[1]
    assert ext[2] == whole[2]


def test_sharded_product_collectives_by_hand(cells):
    """A (8, 16) × (16, 12) product with the contraction split over
    "model" (2 ranks): 2·8·8·12 local FLOPs and a partial sum; its
    all-reduce to replicated moves 2 × 8·12·4 bytes on the ring's wire,
    its reduce-scatter to a row shard the 4·12·4-byte result; an (8, 16)
    row shard over "data" gathered whole: the 8·16·4-byte result."""
    mm = cells["matmul"]
    assert mm["partial"]
    assert mm["flops"] == 2 * 8 * 8 * 12
    assert mm["coll"] == {"all-reduce": 2.0 * 8 * 12 * 4,
                          "reduce-scatter": 4.0 * 12 * 4,
                          "all-gather": 8.0 * 16 * 4}


def test_attention_on_q_head_blocks_by_hand(cells):
    """q heads split over "model" where the kv heads do not divide it:
    each rank's two products, 2·b·(h/4)·s²·hd FLOPs each, and their
    backward (two products of the same size each), against the unsharded
    model's 2·b·h·s²·hd each."""
    cfg = C.smoke(C.SPLIT_ARCH)
    shape = C.shapes()["train"]
    b, s = shape.global_batch, shape.seq_len
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    got = cells["attention_flops"]
    assert got["unsharded"] == 3 * 2 * 2 * b * h * s * s * hd
    assert got["sharded"] == 3 * 2 * 2 * b * (h // 4) * s * s * hd
    assert 4 * got["sharded"] == got["unsharded"]


def test_head_dim_split_decode_by_hand(cells):
    """internlm2's smoke decode on (1, 4) (2 kv heads: the cache split by
    head_dim over "model"): no collective at ``_on_local_blocks`` (the
    cache gather), and in each layer one all-reduce of the float32
    (b, h, 1, skv) partial logits, 2 × b·h·skv·4 bytes on the ring's wire;
    q's and the output's moves into and out of the head_dim split are at
    most q's bytes each."""
    split = cells["split_decode"]
    meta, by = split["meta"], split["by_site_kind"]
    cfg = C.smoke(C.SPLIT_ARCH)
    shape = C.shapes()["decode"]
    b, skv = shape.global_batch, shape.seq_len
    h, hd, layers = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    esize = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                        ).element_size()
    assert "attention.py:_on_local_blocks" not in by
    site = by["attention.py:_over_head_dim"]
    assert site["all-reduce"] == layers * 2.0 * b * h * skv * 4
    moves = sum(v for k, v in site.items() if k != "all-reduce")
    assert 0 < moves <= layers * 2 * b * h * hd * esize
    assert sum(meta["coll_by_site"].values()) == pytest.approx(
        meta["coll_bytes_per_dev"], rel=1e-12, abs=0)


def test_gold_label_gather_backward_at_the_rank_rows(cells):
    """internlm2's smoke train cell on (4, 1), its rows split over 4 data
    ranks (on (1, 4) a rank's rows are the whole batch, so the fault
    cannot show there).  The gold-label gather's backward makes its
    largest storage at the rank's float32 logits block, (b/4)·s·V·4
    bytes, where DTensor's own gather makes it at the global batch's,
    4 × that.  The step's eager-order peak then falls by at least
    (4 - 2) blocks less 1 KiB: the gather's zeros shrink by 3 blocks,
    and the peak moves to the logsumexp backward, whose exp temporary
    holds one block more than the gather's moment; the KiB is the rank's
    gold logits and label rows.  FLOPs and collective bytes stay."""
    got = cells["gold_gather"]
    cfg = C.smoke(C.SPLIT_ARCH)
    shape = C.shapes()["train"]
    block = shape.global_batch // 4 * shape.seq_len * cfg.vocab_size * 4
    local, dtensor = got["local_rows"], got["dtensor"]
    assert local["gather_grad_largest"] == block
    assert dtensor["gather_grad_largest"] == 4 * block
    assert dtensor["peak"] - local["peak"] >= (4 - 2) * block - 1024
    assert local["flops"] == dtensor["flops"]
    assert local["coll"] == dtensor["coll"]


def test_one_rank_dry_run_equals_the_real_step(cells):
    """The (1, 1) dry run's FLOPs against ``roofline.analyze`` of the real
    step (no mesh, real tensors) on the same config and batch shape, and
    its state bytes against the real state's."""
    arch, m = C.ONE_RANK
    meta = cells["one_rank"]
    cfg = C.smoke(arch)
    model = get_model(cfg)
    shape = C.shapes()["train"]
    state = init_train_state(model, 0, device="cpu")
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, dtype=v.dtype)
                 if v.dtype == torch.int32
                 else torch.ones(v.shape, dtype=v.dtype))
             for k, v in model.input_specs(shape).items()}
    step = make_train_step(model, TrainConfig(microbatches=m))
    r = roof.analyze(step, state, batch, device="cpu")
    assert meta["flops_per_dev"] == r.flops
    real = sum(p.numel() * p.element_size() for p in
               state["params"].parameters()) * 3 + 2 * 4
    assert meta["state_bytes_per_dev"] == real
    assert train_state_specs(model)["opt"]["count"] == ()


def test_analyze_books_traced_c10d_collectives(tmp_path):
    """A plain ``all_reduce`` on a 1-rank gloo group inside ``analyze``:
    the traced c10d op's bytes under "all-reduce" (2 × the payload on the
    ring's wire)."""
    from datetime import timedelta

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        t = torch.ones(64, dtype=torch.float32)
        r = roof.analyze(lambda: dist.all_reduce(t), device="cpu")
    finally:
        dist.destroy_process_group()
    assert r.coll_breakdown == {"all-reduce": 2.0 * 64 * 4}
    assert r.coll_bytes == 2.0 * 64 * 4


def test_the_ambient_mesh_is_per_thread():
    import threading

    from repro_torch.launch import mesh as mesh_lib
    seen = []
    with mesh_lib.use_mesh("a mesh", state_overrides={"kv_seq": None}):
        worker = threading.Thread(
            target=lambda: seen.append((mesh_lib.current_mesh(),
                                        mesh_lib.current_state_overrides())))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        assert mesh_lib.current_mesh() == "a mesh"
    assert seen == [(None, None)]
    assert mesh_lib.current_mesh() is None
