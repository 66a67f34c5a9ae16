"""Port parity: ``repro_torch.core.solve`` against ``repro.core.solve`` on
batched Grams, CPU.

Tolerances: solutions of well-conditioned f64 systems rtol 1e-9; f32
systems rtol 1e-4 (κ ≈ 1e2 times f32 eps, different LAPACK paths);
condition estimates rtol 1e-6 (f64) / 1e-3 (f32)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moments as jm
from repro.core import solve as js
from repro_torch.core import moments as tm
from repro_torch.core import solve as ts

torch.set_num_threads(1)


def _grams(seed, npd, batch=4, degree=4, n=64, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (batch, n)).astype(npd)
    y = rng.normal(0, 1, (batch, n)).astype(npd)
    m = tm.gram_moments(torch.from_numpy(x), torch.from_numpy(y), degree)
    return m.gram.numpy(), m.vty.numpy()


@pytest.mark.parametrize("method", ["gauss", "cholesky", "qr", "svd"])
@pytest.mark.parametrize("npd,rtol", [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_every_rung_matches_reference(method, npd, rtol):
    a, b = _grams(0, npd)
    with jax.enable_x64(npd == np.float64):
        ref = np.asarray(js.solve(jnp.asarray(a), jnp.asarray(b), method))
    got = ts.solve(torch.from_numpy(a), torch.from_numpy(b), method)
    assert got.shape == (4, 5) and got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_unbatched_solve():
    a, b = _grams(1, np.float64, batch=1)
    with jax.enable_x64(True):
        ref = np.asarray(js.gaussian_elimination(jnp.asarray(a[0]),
                                                 jnp.asarray(b[0])))
    got = ts.gaussian_elimination(torch.from_numpy(a[0]),
                                  torch.from_numpy(b[0]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


def test_gauss_pivots():
    a = np.array([[[0.0, 1.0], [1.0, 0.0]], [[1e-12, 1.0], [1.0, 1.0]]])
    b = np.array([[2.0, 3.0], [1.0, 2.0]])
    got = ts.gaussian_elimination(torch.from_numpy(a), torch.from_numpy(b))
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_qr_solve_vandermonde():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, 40, 4))
    y = rng.normal(size=(3, 40))
    with jax.enable_x64(True):
        ref = np.asarray(js.qr_solve_vandermonde(jnp.asarray(v),
                                                 jnp.asarray(y)))
    got = ts.qr_solve_vandermonde(torch.from_numpy(v), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize("npd,rtol", [(np.float64, 1e-6), (np.float32, 1e-3)])
def test_condition_estimate(npd, rtol):
    a, _ = _grams(3, npd, lo=-3.0, hi=3.0)
    a = np.concatenate([a, np.zeros_like(a[:1])])      # an all-zero state
    with jax.enable_x64(npd == np.float64):
        ref = np.asarray(js.condition_estimate(jnp.asarray(a)))
    got = ts.condition_estimate(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=rtol)
    assert np.isinf(got[-1]) and np.isinf(ref[-1])


def test_condition_estimate_scale_invariant_and_nonfinite():
    a, _ = _grams(4, np.float64)
    t = torch.from_numpy(a)
    np.testing.assert_allclose(ts.condition_estimate(t * 1e-300).numpy(),
                               ts.condition_estimate(t).numpy(), rtol=1e-9)
    bad = t.clone()
    bad[1, 0, 0] = float("nan")
    bad[2, 1, 2] = float("inf")
    cond = ts.condition_estimate(bad).numpy()
    assert np.isinf(cond[1]) and np.isinf(cond[2]) and np.isfinite(cond[0])


@pytest.mark.parametrize("degree", [0, 2, 3, 4, 5, 6, 8, 9, 12])
@pytest.mark.parametrize("npd", [np.float32, np.float64])
@pytest.mark.parametrize("basis,normalized", [("monomial", False),
                                              ("monomial", True),
                                              ("chebyshev", False)])
def test_select_solver_matches(degree, npd, basis, normalized):
    want = js.select_solver(degree, jnp.dtype(npd), basis=basis,
                            normalized=normalized)
    got = ts.select_solver(degree, getattr(torch, np.dtype(npd).name),
                           basis=basis, normalized=normalized)
    assert got == want


def test_cond_caps():
    assert ts.cond_cap_for(torch.float32) == 3e7
    assert ts.cond_cap_for(torch.float64) == 1e11


def _singular_cases():
    """Constant x (rank 1 Gram), a zero-weight slot (all-zero Gram) and a
    non-PD Gram, beside a healthy one."""
    x = np.random.default_rng(5).uniform(-1, 1, (4, 50))
    x[1] = 0.3
    w = np.ones_like(x)
    w[2] = 0.0
    y = np.random.default_rng(6).normal(size=x.shape)
    m = tm.gram_moments(torch.from_numpy(x), torch.from_numpy(y), 3,
                        weights=torch.from_numpy(w))
    a = m.gram.numpy().copy()
    a[3] = np.diag([1.0, -2.0, 1.0, 1.0])               # indefinite
    return a, m.vty.numpy()


@pytest.mark.parametrize("method", ["gauss", "cholesky", "qr"])
@pytest.mark.parametrize("fallback", ["svd", None])
def test_solve_with_fallback_flags_like_reference(method, fallback):
    a, b = _singular_cases()
    with jax.enable_x64(True):
        rx, rc, ru = map(np.asarray, js.solve_with_fallback(
            jnp.asarray(a), jnp.asarray(b), method=method, fallback=fallback))
    gx, gc, gu = ts.solve_with_fallback(torch.from_numpy(a),
                                        torch.from_numpy(b), method=method,
                                        fallback=fallback)
    np.testing.assert_array_equal(gu.numpy(), ru)
    np.testing.assert_array_equal(np.isfinite(gx.numpy()), np.isfinite(rx))
    np.testing.assert_array_equal(np.isinf(gc.numpy()), np.isinf(rc))
    np.testing.assert_allclose(gx.numpy()[0], rx[0], rtol=1e-9)
    if fallback == "svd":
        assert bool(torch.isfinite(gx).all())           # rescued everywhere
        assert gu.numpy()[1] and gu.numpy()[2] and not gu.numpy()[0]
        fin = np.isfinite(rx).all(-1)
        np.testing.assert_allclose(gx.numpy()[fin], rx[fin], rtol=1e-7,
                                   atol=1e-9)


def test_cholesky_non_pd_gives_nan_not_raise():
    a, b = _singular_cases()
    x = ts.cholesky_solve(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isnan(x[3]).all() and torch.isfinite(x[0]).all()


def test_solve_with_fallback_same_method_flags_only():
    a, b = _singular_cases()
    x, cond, used = ts.solve_with_fallback(torch.from_numpy(a),
                                           torch.from_numpy(b), method="svd",
                                           fallback="svd")
    assert used.numpy()[2] and not used.numpy()[0]


def test_moments_condition_uses_estimate():
    a, _ = _grams(7, np.float64)
    m = tm.Moments(torch.from_numpy(a), torch.zeros(4, 5), torch.zeros(4),
                   torch.zeros(4), torch.zeros(4))
    jmom = jm.Moments(jnp.asarray(a), jnp.zeros((4, 5)), jnp.zeros(4),
                      jnp.zeros(4), jnp.zeros(4))
    with jax.enable_x64(True):
        ref = np.asarray(jmom.condition())
    np.testing.assert_allclose(m.condition().numpy(), ref, rtol=1e-3)


# ------------------------------------------------ the solve kernel's dispatch
@pytest.mark.parametrize("device_type,method,fallback,k,dtype,want", [
    ("cuda", "gauss", "svd", 4, torch.float32, True),
    ("cuda", "gauss", "gauss", 1, torch.float64, True),
    ("cuda", "gauss", None, 8, torch.float32, True),
    ("cpu", "gauss", "svd", 4, torch.float32, False),
    ("cuda", "cholesky", "svd", 4, torch.float64, False),
    ("cuda", "qr", "svd", 4, torch.float32, False),
    ("cuda", "svd", "svd", 4, torch.float32, False),
    ("cuda", "gauss", "qr", 4, torch.float32, False),
    ("cuda", "gauss", "cholesky", 4, torch.float64, False),
    ("cuda", "gauss", "svd", 9, torch.float32, False),
    ("cuda", "gauss", "svd", 0, torch.float32, False),
    ("cuda", "gauss", "svd", 4, torch.float16, False),
    ("cuda", "gauss", "svd", 4, torch.bfloat16, False),
])
def test_solve_kernel_takes(device_type, method, fallback, k, dtype, want):
    """The rule that hands a solve_with_fallback call to the kernel, over
    what the call's inputs show (their device, dtype and shape: stand-ins
    carry a CUDA device here)."""
    from repro_torch.kernels import solve as ksolve
    a = _like(device_type, dtype, (3, k, k))
    b = _like(device_type, dtype, (3, k))
    assert ksolve.takes(a, b, method, fallback) is want


def _like(device_type, dtype, shape):
    """What the dispatch rule reads of a tensor, on any device type."""
    return types.SimpleNamespace(device=torch.device(device_type),
                                 dtype=dtype, shape=torch.Size(shape),
                                 ndim=len(shape))


@pytest.mark.parametrize("case", ["b_dtype", "b_shape", "b_device",
                                  "not_square", "vector"])
def test_solve_kernel_takes_reads_b_and_the_shapes(case):
    """A call whose b, or whose Gram's shape, does not fit stays on the
    plain chain, whatever its rung."""
    from repro_torch.kernels import solve as ksolve
    a = _like("cuda", torch.float32, (3, 4, 4))
    b = _like("cuda", torch.float32, (3, 4))
    assert ksolve.takes(a, b, "gauss", "svd")
    if case == "b_dtype":
        b = _like("cuda", torch.float64, (3, 4))
    elif case == "b_shape":
        b = _like("cuda", torch.float32, (3, 5))
    elif case == "b_device":
        b = _like("cpu", torch.float32, (3, 4))
    elif case == "not_square":
        a = _like("cuda", torch.float32, (3, 4, 5))
    else:
        a, b = _like("cuda", torch.float32, (4,)), _like("cuda",
                                                          torch.float32, ())
    assert not ksolve.takes(a, b, "gauss", "svd")


def _no_library():
    raise AssertionError("the kernel library was asked for")


@pytest.mark.parametrize("case,err,match", [
    ("k9", ValueError, "k=9"),
    ("float16", TypeError, "dtypes"),
    ("b_shape", ValueError, "expected a"),
    ("not_square", ValueError, "expected a"),
    ("b_dtype", TypeError, "dtypes"),
    ("method", ValueError, "method='cholesky'"),
    ("fallback", ValueError, "fallback='qr'"),
    ("cpu", ValueError, "CUDA"),
])
def test_solve_kernel_refuses_before_launch(monkeypatch, case, err, match):
    from repro_torch.kernels import build
    from repro_torch.kernels import solve as ksolve
    monkeypatch.setattr(build, "library", _no_library)
    k = 9 if case == "k9" else 4
    a = torch.eye(k, dtype=torch.float16 if case == "float16"
                  else torch.float32).expand(3, k, k)
    b = torch.ones(3, k, dtype=a.dtype)
    kw = {"method": "gauss", "fallback": "svd", "cond_cap": 3e7}
    if case == "b_shape":
        b = torch.ones(3, k + 1)
    elif case == "not_square":
        a = torch.ones(3, k, k + 1)
    elif case == "b_dtype":
        b = b.double()
    elif case == "method":
        kw["method"] = "cholesky"
    elif case == "fallback":
        kw["fallback"] = "qr"
    with pytest.raises(err, match=match):
        ksolve.solve_small(a, b, **kw)


@pytest.mark.parametrize("fallback", ["svd", "gauss", None])
def test_solve_with_fallback_on_the_cpu_is_the_plain_path(monkeypatch,
                                                          fallback):
    """The CPU never reaches the kernel: the results are the plain
    version's, bit for bit."""
    from repro_torch.kernels import solve as ksolve
    monkeypatch.setattr(ksolve, "solve_small", _no_library)
    a, b = _singular_cases()
    t_a, t_b = torch.from_numpy(a), torch.from_numpy(b)
    got = ts.solve_with_fallback(t_a, t_b, fallback=fallback)
    want = ts.solve_with_fallback_plain(t_a, t_b, fallback=fallback)
    for g, w in zip(got, want):
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
        assert torch.equal(g.isnan(), w.isnan())
