"""Port parity for the mesh executor: ``repro_torch.core.distributed``
(``spec.distributed``, ``make_distributed_fit`` / ``_select``) on gloo
ranks against ``repro.core.distributed``'s ``shard_map`` program on the
same blocks, on the CPU.

* In process: a 1-rank gloo group (set up and torn down per test by the
  ``one_rank`` fixture) against the reference's ``make_host_mesh(data=1)``
  in f32 and f64.
* One spawned run of 4 gloo ranks (``tests/_torch_mesh_ranks.py``) against
  the reference in one subprocess on 8 host devices: 4 blocks (the port's
  ``data=4`` against the reference's ``data=4, model=2``), and the (2, 2)
  data × model mesh with ``data_axes=("data",)`` (replication along the
  model axis) and ``("data", "model")`` (row-major ages over two axes).

Tolerance: the κ-scaled coefficient bound of ``tests/test_api.py``
(200·κ·eps·max(1, max|c|), κ the reference's condition estimate, eps of
the run's dtype) plus the absolute slack of its ``MATRIX_CELLS`` cell
(IRLS 1e-4, LSPIA and robust search 5e-3).  A search must pick the
reference's degree.  Every rank must return the same bits.  Every child
process and collective has its own timeout (a hung rank fails the test,
it does not hang the run).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import api as japi
from repro import core as jcore
from repro.launch import mesh as jmesh
from repro_torch import api, core, engine
from repro_torch.core import distributed
from repro_torch.launch import mesh as mesh_lib

ROOT = Path(__file__).resolve().parents[1]
HELPER = Path(__file__).resolve().parent / "_torch_mesh_ranks.py"
_spec = importlib.util.spec_from_file_location("_torch_mesh_ranks", HELPER)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

CHILD_TIMEOUT = 400      # seconds for the reference / each rank process
ONE_RANK = [(c, dt) for c in R.SPECS for dt in ("float32", "float64")]


def _tol(cond, coeffs, dtype, slack):
    kappa = 1.0
    k = float(np.max(np.asarray(cond)))
    if np.isfinite(k):
        kappa = max(kappa, k)
    cscale = max(1.0, float(np.max(np.abs(coeffs))))
    return 200.0 * kappa * float(np.finfo(dtype).eps) * cscale + slack


@pytest.fixture
def one_rank(tmp_path):
    """A 1-rank gloo group and its (1, 1) CPU mesh, destroyed after."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        yield mesh_lib.make_host_mesh(data=1, device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def multi():
    """The reference subprocess and the 4 port ranks, started together;
    each is killed if it outlives CHILD_TIMEOUT or another one fails."""
    with tempfile.TemporaryDirectory() as d:
        renv = _env()
        renv.update(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                    JAX_PLATFORMS="cpu")
        procs = [subprocess.Popen(
            [sys.executable, str(HELPER), "reference", f"{d}/ref.npz"],
            env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
        procs += [subprocess.Popen(
            [sys.executable, str(HELPER), "rank", str(r), str(R.WORLD),
             f"{d}/store", f"{d}/rank{r}.npz"],
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
        ref = dict(np.load(f"{d}/ref.npz"))
        ranks = [dict(np.load(f"{d}/rank{r}.npz")) for r in range(R.WORLD)]
    return ref, ranks


def _reference_one_device(case, dtype):
    _, build, ykind, _ = R.CASE[case]
    mesh = jmesh.make_host_mesh(data=1)
    with jax.enable_x64(dtype == "float64"):
        x, y, w = (None if a is None else jnp.asarray(a)
                   for a in R.data(ykind, dtype))
        res = build(japi).distributed(mesh)(x, y, w)
        best = (-1 if res.selection is None
                else int(np.asarray(res.selection.best_degree)))
        return (np.asarray(res.coeffs), best,
                np.asarray(res.poly.diagnostics.condition),
                None if res.report is None else np.asarray(res.report.count))


# --------------------------------------------------------------------------
# (a) one rank, in process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case,dtype", ONE_RANK,
                         ids=[f"{c}-{d}" for c, d in ONE_RANK])
def test_one_rank_mesh_against_reference(one_rank, case, dtype):
    want, best, cond, count = _reference_one_device(case, dtype)
    _, build, ykind, slack = R.CASE[case]
    x, y, w = (None if a is None else torch.from_numpy(a)
               for a in R.data(ykind, dtype))
    res = build(api).distributed(one_rank)(x, y, w)
    got = res.coeffs.numpy()
    tol = _tol(cond, want, dtype, slack)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert (-1 if res.selection is None else res.best_degree) == best
    if count is not None and res.iterations is None:
        np.testing.assert_allclose(res.report.count.numpy(), count,
                                   rtol=100 * np.finfo(dtype).eps)


# --------------------------------------------------------------------------
# (b), (c) four gloo ranks against the reference on 8 host devices
# --------------------------------------------------------------------------
RUN_IDS = [R.run_id(*r) for r in R.RUNS]


@pytest.mark.parametrize("run", R.RUNS, ids=RUN_IDS)
def test_mesh_against_reference(multi, run):
    ref, ranks = multi
    case, _, axes, dtype = run
    rid = R.run_id(*run)
    want = ref[rid + ".coeffs"]
    got = ranks[0][rid + ".coeffs"]
    tol = _tol(ref[rid + ".cond"], want, dtype, R.CASE[case][3])
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert int(ranks[0][rid + ".best"]) == int(ref[rid + ".best"])
    iterative = int(ref[rid + ".iterations"]) >= 0
    if not iterative and np.isfinite(ref[rid + ".count"]):
        np.testing.assert_allclose(ranks[0][rid + ".count"],
                                   ref[rid + ".count"],
                                   rtol=100 * np.finfo(dtype).eps)


def test_every_rank_returns_the_same_bits(multi):
    _, ranks = multi
    keys = [k for k in ranks[0] if k != "seconds"]
    assert len(keys) == 6 * len(R.RUNS)
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_padding_counts_only_weighted_points(multi):
    ref, ranks = multi
    rid = R.run_id("shim-fit-padding", "d4", ("data",), "float32")
    assert float(ranks[0][rid + ".count"]) == 1000.0
    np.testing.assert_allclose(ranks[0][rid + ".coeffs"], [2.0, 0.5],
                               atol=1e-3)


def test_one_sum_per_data_axis_plus_min_max_when_normalized(multi):
    _, ranks = multi
    for case, mesh, axes, dtype in R.RUNS:
        if case not in ("lse-monomial-d3", "shim-fit-normalize"):
            continue
        sums, mins, maxs, nbytes = ranks[0][
            R.run_id(case, mesh, axes, dtype) + ".collectives"]
        norm = case == "shim-fit-normalize"
        k = 4                                    # degree 3
        item = np.dtype(dtype).itemsize
        assert (sums, mins, maxs) == (len(axes), len(axes) * norm,
                                      len(axes) * norm)
        assert nbytes == len(axes) * item * (k * k + k + 3 + 2 * norm)


# --------------------------------------------------------------------------
# the collective counter, validation and the mismatches that raise
# --------------------------------------------------------------------------
def _series(n):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
    return x, 1.0 - 0.5 * x + 0.3 * x ** 3


@pytest.mark.parametrize("spec", [
    api.FitSpec(degree=3),
    api.FitSpec(degree=3, numerics=api.NumericsPolicy(normalize=True)),
    api.FitSpec(degree=api.DegreeSearch(max_degree=5, folds=4)),
    api.FitSpec(degree=3, method="irls",
                irls=api.IRLSOptions(max_iter=3, tol=0.0))],
    ids=["lse", "normalized", "search-cv", "irls"])
def test_collective_payload_does_not_grow_with_n(one_rank, spec):
    run = spec.distributed(one_rank)
    seen = []
    for n in (4096, 8192):
        x, y = _series(n)
        engine.reset_collective_counter()
        run(x, y)
        seen.append(engine.collective_counter())
    assert seen[0] == seen[1]
    if spec == api.FitSpec(degree=3):
        assert seen[0] == {"calls": 1, "bytes": 23 * 4, "sum": 1, "min": 0,
                           "max": 0}


NORMALIZED = api.FitSpec(degree=3,
                         numerics=api.NumericsPolicy(normalize=True))


def test_mesh_fit_nests_its_spans(one_rank):
    """One normalized fit: ``api.distributed`` holds ``fit.domain`` with
    the MIN and MAX all-reduces, then the moments' SUM all-reduce; the
    collective counter reads as before the spans."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import spans
    x, y = _series(4096)
    run = NORMALIZED.distributed(one_rank)
    spans.clear()
    engine.reset_collective_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            run(x, y)
        rec = spans.recorded()
    finally:
        spans.clear()

    def kids(i):
        return sorted((s for s in rec if s.parent == i),
                      key=lambda s: s.start_us)

    assert [s.name for s in kids(-1)] == ["api.distributed"]
    root = rec.index(kids(-1)[0])
    assert [s.name for s in kids(root)] == [
        "fit.domain", "fit.plan", "fit.moments", "mesh.allreduce",
        "fit.solve", "fit.report"]
    domain = rec.index(kids(root)[0])
    assert [s.name for s in kids(domain)] == ["mesh.allreduce"] * 2
    for s in rec:
        assert s.end_us is not None
        if s.parent >= 0:
            up = rec[s.parent]
            assert up.start_us <= s.start_us and s.end_us <= up.end_us
    assert engine.collective_counter() == {
        "calls": 3, "bytes": 4 * (2 + 23), "sum": 1, "min": 1, "max": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_domain_apply_keeps_the_bits_of_the_two_step_map(one_rank,
                                                         monkeypatch, dtype):
    """The plain mesh fit hands its moment pass raw x and the global
    domain (a kernel plan maps x as the kernel loads it): the block's
    moments are bit-equal to those of ``local_moments(Domain.apply(x))``,
    the one-temporary map whose bits are those of ``(x - shift) *
    scale``, and the fit carries that domain."""
    from repro_torch.core import basis
    seen = []
    real = distributed.local_moments

    def spy(xin, yin, degree, **kw):
        out = real(xin, yin, degree, **kw)
        seen.append((xin, degree, kw, out))
        return out

    monkeypatch.setattr(distributed, "local_moments", spy)
    x, y = (a.to(dtype) * 1.7 + 0.3 for a in _series(4096))
    res = NORMALIZED.distributed(one_rank)(x, y)
    (xin, degree, kw, got), = seen
    dom = kw.pop("domain")
    assert xin is x and isinstance(dom, basis.Domain)
    assert float(dom.scale) != 1.0 and float(dom.shift) != 0.0
    out = dom.apply(x)
    assert out.dtype == dtype
    assert torch.equal(out, (x - dom.shift) * dom.scale)
    want = real(out, y, degree, **kw)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f
    assert torch.equal(res.poly.domain_shift, dom.shift)
    assert torch.equal(res.poly.domain_scale, dom.scale)


MESH_METHODS = {
    "lse": {},
    "irls": {"method": "irls",
             "irls": api.IRLSOptions(max_iter=3, tol=0.0)},
    "lspia": {"method": "lspia"},
    "search": {"degree": api.DegreeSearch(max_degree=5, folds=0)},
}


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("method", list(MESH_METHODS))
def test_mesh_reads_the_global_domain_only_when_nothing_is_pinned(
        one_rank, monkeypatch, method, pinned):
    """Under ``normalize=True`` the mesh's data-derived domain is the
    global one (``_global_domain``: the block's min/max and two
    all-reduces).  With a domain pinned no program computes it; with none
    pinned each computes it once, and its coefficients and domain are
    bit-equal to the same fit with that domain pinned."""
    calls = []
    real = distributed._global_domain

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(distributed, "_global_domain", spy)
    kw = {"degree": 3, **MESH_METHODS[method]}
    x, y = _series(4096)

    def fit(domain):
        spec = api.FitSpec(domain=domain,
                           numerics=api.NumericsPolicy(normalize=True), **kw)
        return spec.distributed(one_rank)(x, y).poly

    if pinned:
        got = fit((0.5, 0.25))
        assert calls == []
        assert (float(got.domain_shift), float(got.domain_scale)) == (
            0.5, 0.25)
        return
    got = fit(None)
    assert len(calls) == 1
    want = fit((float(got.domain_shift), float(got.domain_scale)))
    assert len(calls) == 1
    for f in ("coeffs", "domain_shift", "domain_scale"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_forced_kernel_with_chebyshev_raises_eagerly(one_rank):
    with pytest.raises(ValueError, match="monomial"):
        core.make_distributed_fit(one_rank, 2, basis="chebyshev",
                                  engine="kernel")
    x, y = _series(64)
    with pytest.raises(ValueError, match="monomial"):
        core.local_moments(x, y, 2, basis="chebyshev", engine="kernel")


def test_raw_data_solver_refused_on_the_mesh(one_rank):
    spec = api.FitSpec(numerics=api.NumericsPolicy(solver="qr_vandermonde"))
    with pytest.raises(ValueError, match="Vandermonde"):
        spec.distributed(one_rank)


def test_cv_needs_folds(one_rank):
    spec = api.FitSpec(degree=api.DegreeSearch(max_degree=3, folds=0,
                                               criterion="cv"))
    with pytest.raises(ValueError, match="folds"):
        spec.distributed(one_rank)


def test_runner_without_a_group_raises(one_rank):
    run = core.make_distributed_fit(one_rank, 2)
    dist.destroy_process_group()
    x, y = _series(64)
    with pytest.raises(RuntimeError, match="init_process_group"):
        run(x, y)


def test_mesh_without_a_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_host_mesh(data=1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_lib.make_production_mesh()


def test_mesh_size_must_match_the_group(one_rank):
    with pytest.raises(ValueError, match="256 ranks"):
        mesh_lib.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    assert mesh_lib.required_devices(False) == 256
    assert mesh_lib.required_devices(True) == 512
    assert mesh_lib.required_devices(True) == jmesh.required_devices(True)


def test_data_on_another_device_type_raises(one_rank):
    run = core.make_distributed_fit(one_rank, 2)
    x = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="mesh is over"):
        run(x, x)


def test_nccl_group_refuses_cpu_tensors(one_rank, monkeypatch):
    run = core.make_distributed_fit(one_rank, 2)
    monkeypatch.setattr(distributed.dist, "get_backend", lambda g: "nccl")
    x, y = _series(64)
    with pytest.raises(ValueError, match="NCCL"):
        run(x, y)


def test_unknown_data_axis_raises(one_rank):
    with pytest.raises(ValueError, match="not an axis"):
        core.make_distributed_fit(one_rank, 2, data_axes=("pod",))


def test_local_moments_plans_on_the_block_device(one_rank, monkeypatch):
    """A shard planned without its device would take the CPU path for a
    CUDA block without a word: every plan of the mesh executor carries
    the block's device."""
    seen = []
    real = engine.plan_fit

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(distributed.engine_lib, "plan_fit", spy)
    x, y = _series(256)
    api.FitSpec(degree=3).distributed(one_rank)(x, y)
    assert seen == [x.device]


@dataclasses.dataclass
class _FakeMesh:
    mesh_dim_names: tuple
    sizes: tuple

    def size(self, dim):
        return self.sizes[dim]


def test_plan_marks_shards_of_a_mesh():
    m = _FakeMesh(("data", "model"), (4, 2))
    p = engine.plan_fit((256,), 3, mesh=m, data_axes=("data",))
    assert p.distributed and p.devices == 4 and "x4shards" in p.describe()
    p = engine.plan_fit((256,), 3, mesh=m, data_axes=("data", "model"))
    assert p.devices == 8
    p = api.FitSpec(degree=3).plan((256,), torch.float32, mesh=m,
                                   data_axes=("model",))
    assert p.devices == 2
    p = engine.plan_fit((256,), 3)
    assert not p.distributed and p.devices == 1
    assert "shards" not in p.describe()


def test_input_specs_are_meta_tensors():
    specs = distributed.distributed_fit_input_specs(1 << 20,
                                                    torch.float64)
    assert set(specs) == {"x", "y", "weights"}
    for t in specs.values():
        assert t.device.type == "meta" and t.shape == (1 << 20,)
        assert t.dtype == torch.float64


def test_exports_match_the_reference():
    for name in ("make_distributed_fit", "make_distributed_select",
                 "local_moments", "psum_moments"):
        assert name in core.__all__ and name in jcore.__all__
    assert "make_distributed" in api.__all__
    assert "make_distributed" in japi.__all__
