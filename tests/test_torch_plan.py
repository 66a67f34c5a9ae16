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
    teng.compute_moments(p, x, x)
    assert teng.moment_counter() == {"calls": 2, "points": 120}
    teng.reset_moment_counter()
    assert teng.moment_counter() == {"calls": 0, "points": 0}
