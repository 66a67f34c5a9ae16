"""Port parity: ``repro_torch.engine.plan_fit`` against
``repro.engine.plan_fit`` over shapes × degrees × bases × engines ×
workloads.  The port's ``backend="cuda"`` is compared with the reference's
``"tpu"``, and its CPU with the reference's CPU."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jeng
from repro_torch import engine as teng

torch.set_num_threads(1)

SHAPES = [(64,), (1 << 15,), (1 << 16,), (2, 64), (3, 5000), (4, 2, 100)]
DEGREES = [0, 3, 6, 8, 62, 63, 126, 127]
BASES = ["monomial", "chebyshev"]
BACKENDS = [("cpu", "cpu"), ("cuda", "tpu")]


def _outcome(fn):
    try:
        p = fn()
    except ValueError as e:
        return ("error", type(e).__name__)
    return (p.path, p.reason.replace("jnp", "torch"),
            p.numerics.normalize, p.numerics.solver, p.numerics.fallback)


@pytest.mark.parametrize("engine", teng.ENGINES)
@pytest.mark.parametrize("workload", ["moments", "select", "report", "lspia"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("npd", [np.float32, np.float64])
def test_plan_matches_reference(engine, workload, backend, npd):
    tb, jb = backend
    tdt = getattr(torch, np.dtype(npd).name)
    for shape, degree, basis in itertools.product(SHAPES, DEGREES, BASES):
        want = _outcome(lambda: jeng.plan_fit(
            shape, degree, basis=basis, dtype=jnp.dtype(npd), engine=engine,
            backend=jb, workload=workload))
        got = _outcome(lambda: teng.plan_fit(
            shape, degree, basis=basis, dtype=tdt, engine=engine,
            backend=tb, workload=workload))
        assert got[0] == want[0], (shape, degree, basis, got, want)
        if got[0] != "error":
            assert got[2:] == want[2:], (shape, degree, basis, got, want)
            if not want[1].startswith("auto: backend"):
                assert got[1] == want[1], (shape, degree, basis)


def test_plan_from_device_and_describe():
    p = teng.plan_fit((4, 1000), 3, device=torch.device("cpu"))
    assert p.path == teng.REFERENCE and "backend=cpu" in p.reason
    p = teng.plan_fit((4, 1000), 3, device="cpu", backend="cuda")
    assert p.path == teng.KERNEL_PACKED and p.packing == "packed"
    assert p.uses_kernel and "kernel_packed" in p.describe()
    p = teng.plan_fit((1 << 16,), 7, backend="cuda")
    assert p.path == teng.KERNEL_PLAIN and p.packing == "plain"
    assert p.numerics.normalize and p.numerics.solver == "cholesky"


def test_crossovers_keep_reference_values():
    assert teng.PACKED_MIN_BATCH == jeng.PACKED_MIN_BATCH
    assert teng.KERNEL_MIN_POINTS == jeng.KERNEL_MIN_POINTS
    assert teng.AUTO_NORMALIZE_DEGREE_F32 == jeng.AUTO_NORMALIZE_DEGREE_F32
    assert teng.AUTO_NORMALIZE_DEGREE_F64 == jeng.AUTO_NORMALIZE_DEGREE_F64


@pytest.mark.parametrize("kwargs", [
    dict(solver="qr_vandermonde"), dict(solver="lspia"), dict(solver="lu"),
    dict(fallback="lu"), dict(engine="fast"), dict(workload="train")])
def test_plan_validation(kwargs):
    with pytest.raises(ValueError):
        teng.plan_fit((10,), 3, **kwargs)


def test_moment_counter_counts_passes():
    teng.reset_moment_counter()
    p = teng.plan_fit((2, 30), 2)
    x = torch.rand(2, 30, dtype=torch.float64)
    teng.compute_moments(p, x, x)
    teng.compute_moments(p, x, x, torch.ones_like(x))
    assert teng.moment_counter() == {"calls": 2, "points": 120,
                                     "weighted": 1}
    teng.reset_moment_counter()
    assert teng.moment_counter() == {"calls": 0, "points": 0, "weighted": 0}


# ------------------------------------------- the deprecated use_kernel= alias
def _series(seed, shape, dtype=np.float32):
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 2.0, shape)
    y = 1.0 - 2.0 * x + 0.5 * x ** 3 + 0.05 * r.normal(size=shape)
    return x.astype(dtype), y.astype(dtype)


def test_resolve_engine_maps_and_warns_as_the_reference():
    for use_kernel, mapped in ((True, "kernel"), (False, "reference")):
        with pytest.warns(DeprecationWarning, match="use_kernel") as got:
            assert teng.resolve_engine("auto", use_kernel) == mapped
        with pytest.warns(DeprecationWarning, match="use_kernel") as want:
            assert jeng.resolve_engine("auto", use_kernel) == mapped
        assert str(got[0].message) == str(want[0].message)
        with pytest.warns(DeprecationWarning):
            assert teng.resolve_engine(mapped, use_kernel) == mapped
    assert teng.resolve_engine("auto", None) == "auto"
    assert teng.resolve_engine("kernel_packed", None) == "kernel_packed"


@pytest.mark.parametrize("engine,use_kernel", [
    ("kernel_packed", False), ("reference", True), ("kernel", False),
    ("kernel_plain", True)])
def test_use_kernel_conflicting_with_engine_raises(engine, use_kernel):
    from repro_torch import core
    x, y = _series(10, (4, 128))
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicting") as got:
            core.polyfit(x, y, 2, engine=engine, use_kernel=use_kernel,
                         device="cpu")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicting") as want:
            jeng.resolve_engine(engine, use_kernel)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("use_kernel,engine", [(True, "kernel"),
                                               (False, "reference")])
def test_polyfit_use_kernel_is_bit_equal_to_engine(use_kernel, engine):
    from repro_torch import core
    x, y = _series(11, (3, 259))
    want = core.polyfit(x, y, 2, engine=engine, device="cpu").coeffs
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        got = core.polyfit(x, y, 2, use_kernel=use_kernel,
                           device="cpu").coeffs
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_polyfit_use_kernel_against_the_reference(use_kernel):
    """The port's polyfit(..., use_kernel=) against the reference's on the
    same numpy inputs.  The reference path at float64, to the spec parity
    test's 1e-9 (tests/test_torch_fit.py); the kernel path (float32 moments
    on both sides) on its fitted values, to the conformance suite's
    2·max(200·eps·√κ, 50·eps) (tests/test_torch_conformance.py)."""
    import jax
    from repro import core as jcore
    from repro_torch import core
    dtype = np.float32 if use_kernel else np.float64
    x, y = _series(12, (3, 120), dtype)
    with jax.enable_x64(not use_kernel):
        with pytest.warns(DeprecationWarning, match="use_kernel"):
            want = np.asarray(jcore.polyfit(jnp.asarray(x), jnp.asarray(y),
                                            3, use_kernel=use_kernel).coeffs,
                              np.float64)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        poly = core.polyfit(x, y, 3, use_kernel=use_kernel, device="cpu")
    got = poly.coeffs.double().numpy()
    if not use_kernel:
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-9
        return
    xs = x.astype(np.float64)
    eps = float(np.finfo(np.float32).eps)
    cond = float(poly.diagnostics.condition.max())
    tol = 2 * max(200.0 * eps * np.sqrt(cond), 50.0 * eps)
    for i in range(3):
        a = np.polynomial.polynomial.polyval(xs[i], got[i])
        b = np.polynomial.polynomial.polyval(xs[i], want[i])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= tol


@pytest.mark.parametrize("use_kernel,engine", [(True, "kernel"),
                                               (False, "reference")])
def test_streaming_update_use_kernel_maps(use_kernel, engine):
    from repro_torch.core import streaming
    x, y = _series(13, (2, 263))
    st = streaming.StreamState.create(2, (2,), device="cpu")
    want = streaming.update(st, x, y, engine=engine)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        got = streaming.update(st, x, y, use_kernel=use_kernel)
    assert torch.equal(got.moments.gram, want.moments.gram)
    assert torch.equal(got.moments.vty, want.moments.vty)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicting"):
            streaming.update(st, x, y, engine="kernel_packed",
                             use_kernel=False)


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A 1-rank gloo group and its (1, 1) CPU mesh, destroyed after."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=timedelta(seconds=60))
    try:
        yield mesh_lib.make_host_mesh(data=1, device_type="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("use_kernel,engine", [(True, "kernel"),
                                               (False, "reference")])
def test_distributed_use_kernel_maps(one_rank_mesh, use_kernel, engine):
    from repro_torch.core import distributed
    x, y = (torch.from_numpy(a) for a in _series(14, (512,)))
    want = distributed.local_moments(x, y, 3, engine=engine)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        got = distributed.local_moments(x, y, 3, use_kernel=use_kernel)
    assert torch.equal(got.gram, want.gram) and torch.equal(got.vty,
                                                            want.vty)
    fit_want = distributed.make_distributed_fit(one_rank_mesh, 3,
                                                engine=engine)
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        fit_got = distributed.make_distributed_fit(one_rank_mesh, 3,
                                                   use_kernel=use_kernel)
    pw, mw = fit_want(x, y, None)
    pg, mg = fit_got(x, y, None)
    assert torch.equal(pg.coeffs, pw.coeffs)
    assert torch.equal(mg.gram, mw.gram)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="conflicting"):
            distributed.make_distributed_fit(one_rank_mesh, 3,
                                             engine="kernel_plain",
                                             use_kernel=False)
