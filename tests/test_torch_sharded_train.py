"""Sharded training on 4 gloo CPU ranks against the single-process step.

Each group of checks starts 4 ranks once (``tests/_torch_sharded_ranks.py``
rank GROUP ..., one ``FileStore``, each rank with its own timeout, so a
hung rank fails the test instead of the run):

* ``train``: one step of each family's smoke config (internlm2 dense,
  phi3.5 MoE, llava VLM, rwkv6, zamba2, whisper, and qwen1.5 with 2 heads
  for its query-sequence attention blocks; float32 compute) on
  meshes (4, 1), (2, 2) and (1, 4), every leaf a DTensor, against the
  same step in this process without a mesh: loss and grad_norm within
  1e-5 relative; each parameter and mu by phase 15a's rule
  (``chip_smoke.py``'s ``_train_close``, TOL = 1e-4): a parameter within
  2·lr + TOL·max|p| (Adam's first step moves an element whose gradient is
  near 0 by ±lr, and two float32 orders of one sum can give that gradient
  either sign), mu (0.1 · the clipped gradient) within TOL·max|mu| of its
  tensor (``RESIDUAL_GRADS``, rounding residuals, of the model's largest
  mu).  Sharded products sum their terms in other orders (partial sums
  per rank, then a reduction across ranks): rwkv6's time-mix gradients on
  (1, 4) differ by up to 2.5e-5 of their tensor's largest mu;
* ``launcher``: ``launch.train --model-parallel 2`` on the 4 ranks
  against the one-process launcher over 5 steps (float32 compute);
* ``resume``: a state saved on (4, 1) after 2 steps restores onto (2, 2)
  bit for bit and replays step 3 as the unbroken run does (loss within
  1e-5, parameters by the rule above).

The ``train`` group also holds ``init_train_state(mesh=)``: each rank's
blocks bit-equal to the single-process state's, and the bytes it holds
at once bounded by its share of the state plus one leaf drawn whole.  In
this process, on a 1-rank mesh: the MoE combine and ``chunked_gla``'s
ragged pad receive plain tensors (their local-block form).

Without a mesh, ``constrain`` is the identity: every model's outputs are
bit-equal with it replaced by ``lambda x, *a, **k: x``.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import get_model
from repro_torch.sharding import rules
from repro_torch.train import TrainConfig, init_train_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent
HELPER = ROOT / "tests" / "_torch_sharded_ranks.py"
_spec = importlib.util.spec_from_file_location("_torch_sharded_ranks", HELPER)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

CHILD_TIMEOUT = 900
F32 = 1e-5
TOL = 1e-4          # phase 15a's rule for parameters and moments
# leaves whose gradient is a float32 residual (zero in exact arithmetic, as
# a key bias's: a softmax is invariant to a shift of one query's logits;
# or cancelling sums, as Mamba2's decays): their mu is held to TOL of the
# model's largest mu, as tests/test_torch_train_step.py holds them
RESIDUAL_GRADS = ("bk", "a_log", "dt_bias")
torch.set_num_threads(1)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("WORLD_SIZE", None)
    return env


def run_ranks(group):
    """Start the 4 ranks of ``group`` together and return rank 0's
    arrays; each rank is killed if it outlives CHILD_TIMEOUT or another
    one fails."""
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, str(HELPER), "rank", group, str(r),
             str(R.WORLD), f"{d}/store", f"{d}/out.npz"],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(R.WORLD)]
        try:
            for p in procs:
                out = p.communicate(timeout=CHILD_TIMEOUT)[0]
                assert p.returncode == 0, out.decode()[-4000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        return dict(np.load(f"{d}/out.npz"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _hold_params(got, want_params, lr, prefix):
    for n, p in want_params.items():
        want = _np(p)
        err = np.abs(got[f"{prefix}/p/{n}"] - want).max()
        assert err <= 2 * lr + TOL * np.abs(want).max(), (prefix, n, err)


@pytest.fixture(scope="module")
def train_ranks():
    return run_ranks("train")


def _single_step(arch):
    cfg = R.f32_config(arch)
    model = get_model(cfg)
    state = init_train_state(model, R.SEED, device="cpu")
    return make_train_step(model, TrainConfig())(
        state, R.tensors(R.batch(cfg)))


@pytest.mark.parametrize("arch", R.TRAIN_ARCHS)
def test_sharded_step_equals_the_single_process_step(train_ranks, arch):
    state, m = _single_step(arch)
    lr = float(m["lr"])
    mus = state["opt"]["mu"]
    top_mu = max(np.abs(_np(v)).max() for v in mus.values())
    params = dict(state["params"].named_parameters())
    for shape in R.MESHES:
        key = f"{arch}/{shape[0]}x{shape[1]}"
        assert bool(train_ranks[f"{key}/all_dtensor"]), key
        assert _rel(train_ranks[f"{key}/loss"], _np(m["loss"])) <= F32, key
        assert _rel(train_ranks[f"{key}/grad_norm"],
                    _np(m["grad_norm"])) <= F32, key
        _hold_params(train_ranks, params, lr, key)
        for n, mu in mus.items():
            got = train_ranks[f"{key}/mu/{n}"]
            if n.rpartition(".")[2] in RESIDUAL_GRADS:
                err = np.abs(got - _np(mu)).max()
                assert err <= TOL * top_mu, (key, n, err)
            else:
                assert _rel(got, _np(mu)) <= TOL, (key, n)


@pytest.mark.parametrize("arch", R.TRAIN_ARCHS)
def test_sharded_init_draws_each_rank_blocks_alone(train_ranks, arch):
    """``init_train_state(mesh=)`` on (4, 1), (2, 2) and (1, 4): every
    rank's blocks of the parameters, mu and nu (and its count and step)
    are bit-equal to the matching blocks of the single-process
    ``init_train_state(model, SEED)``, and the most bytes live at once
    during the call (``CostCounter``'s eager-order peak) are at most the
    rank's state bytes plus the peak of drawing the model's largest leaf
    whole (its truncated-normal draw's temporaries included), where the
    whole state drawn on every rank first held 3 × the float32
    parameters."""
    for shape in R.MESHES:
        key = f"{arch}/{shape[0]}x{shape[1]}"
        assert train_ranks[f"{key}/init_equal"].all(), key
        peak = train_ranks[f"{key}/init_peak"]
        bound = train_ranks[f"{key}/init_state"] + train_ranks[
            f"{key}/init_leaf"]
        assert (peak <= bound).all(), (key, peak, bound)


def test_model_parallel_launcher_equals_one_process(monkeypatch):
    got = run_ranks("launcher")
    assert tuple(got["mesh"]) == (2, 2)
    from repro_torch.launch import train as train_lib
    monkeypatch.setattr(configs, "get_smoke_config",
                        R.f32_smoke_getter(configs))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    run = train_lib.run(R.LAUNCH_ARGS)
    assert run["mesh"] is None
    want = np.asarray([run["losses"][s] for s in sorted(run["losses"])])
    assert len(want) == R.LAUNCH_STEPS == len(got["losses"])
    np.testing.assert_allclose(got["losses"], want, rtol=F32, atol=0)


def test_resume_onto_another_mesh_replays_the_unbroken_run():
    got = run_ranks("resume")
    assert tuple(got["restored_mesh"]) == (2, 2)
    assert bool(got["restored_equal"])
    assert int(got["restored_step"]) == 2
    assert _rel(got["resumed/loss"], got["unbroken/loss"]) <= F32
    model = get_model(R.f32_config(R.RESUME_ARCH))
    names = [n for n, _ in model.abstract_params().named_parameters()]
    lr = float(TrainConfig().optimizer.peak_lr) * 3 / \
        TrainConfig().optimizer.warmup_steps
    for n in names:
        want = got[f"unbroken/p/{n}"]
        err = np.abs(got[f"resumed/p/{n}"] - want).max()
        assert err <= 2 * lr + TOL * np.abs(want).max(), (n, err)


# ------------------------------------- local blocks under a mesh, any torch
def test_moe_combine_and_gla_pad_take_plain_tensors(tmp_path, monkeypatch):
    """Under a mesh the MoE's combine product and ``chunked_gla``'s pad of a
    ragged sequence run on each rank's blocks: they receive plain
    tensors, never DTensors.  DTensor's own strategies for them fail on
    torch 2.11 (the combine flattens a sharded expert axis; the pad's
    redistribute planner raises an ``IndexError`` with the sequence
    split), so this holds the repair on any torch.  phi3.5's and zamba2's
    smoke train steps on a 1-rank (1, 1) mesh, zamba2 at 20 tokens a row
    (chunk 16: padded)."""
    from datetime import timedelta

    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor
    from repro_torch.train.train_step import shard_batch
    seen = {"combine": [], "pad": []}
    einsum, pad = torch.einsum, F.pad

    def spy_einsum(eq, *ops):
        if eq == "gsec,egcd->gsd":
            seen["combine"].append(any(isinstance(o, DTensor) for o in ops))
        return einsum(eq, *ops)

    def spy_pad(a, *args, **kwargs):
        if sys._getframe(1).f_code.co_filename.endswith("gla.py"):
            seen["pad"].append(isinstance(a, DTensor))
        return pad(a, *args, **kwargs)

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        mesh = mesh_lib.make_host_mesh(data=1, model=1, device_type="cpu")
        monkeypatch.setattr(torch, "einsum", spy_einsum)
        monkeypatch.setattr(F, "pad", spy_pad)
        for arch, s in (("phi3.5-moe-42b-a6.6b", 32), ("zamba2-7b", 20)):
            cfg = R.f32_config(arch)
            model = get_model(cfg)
            state = init_train_state(model, R.SEED, device="cpu", mesh=mesh)
            _, m = make_train_step(model, TrainConfig())(
                state, shard_batch(R.tensors(R.batch(cfg, s=s)), mesh))
            assert np.isfinite(float(m["loss"].full_tensor())), arch
    finally:
        dist.destroy_process_group()
    assert seen["combine"] and not any(seen["combine"]), seen
    assert seen["pad"] and not any(seen["pad"]), seen


# ------------------------------------------------ constrain without a mesh
MODEL_MODULES = ["attention", "moe", "gla", "mamba2", "rwkv6", "encdec",
                 "transformer", "zamba2", "rwkv6_model"]
ALL_ARCHS = list(configs.ARCHS)


def test_constrain_without_a_mesh_is_the_identity():
    assert mesh_lib.current_mesh() is None
    x = torch.randn(2, 3, 4)
    assert rules.constrain(x, "batch", None, "mlp") is x
    state = {"k": x, "len": 3}
    assert rules.constrain_state(state, {"k": ("batch", None, None),
                                         "len": ()}) is state


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_models_are_bit_equal_with_constrain_replaced(arch, monkeypatch):
    """Every family's train forward, prefill and decode with the real
    ``constrain`` (no mesh) against the same with the identity in its
    place; the constraint points are reached."""
    import importlib
    cfg = R.f32_config(arch)
    model = get_model(cfg)
    params = model.init_params(0, device="cpu")
    cp = model.compute_params(params)
    b = R.tensors(R.batch(cfg, b=2, s=16))
    fwd_batch = {k: v for k, v in b.items() if k not in ("labels",
                                                         "loss_mask")}
    prompt = ({"frames": b["frames"], "dec_tokens": b["dec_tokens"]}
              if cfg.family == "audio" else fwd_batch)

    def run():
        with torch.no_grad():
            logits, aux = model.forward_train(params, fwd_batch)
            pl, st = model.prefill(cp, prompt, 40)
            tok = torch.argmax(pl[:, -1:], -1).to(torch.int32)
            dl, _ = model.decode_step(cp, tok, st)
        return [logits, aux, pl, dl]

    calls = []
    real = rules.constrain

    def spy(x, *a, **k):
        calls.append(a)
        out = real(x, *a, **k)
        assert out is x
        return out

    mods = [importlib.import_module(f"repro_torch.models.{m}")
            for m in MODEL_MODULES]
    for m in mods:
        if hasattr(m, "constrain"):
            monkeypatch.setattr(m, "constrain", spy)
    want = run()
    assert calls, "no constraint point was reached"
    for m in mods:
        if hasattr(m, "constrain"):
            monkeypatch.setattr(m, "constrain", lambda x, *a, **k: x)
    got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
