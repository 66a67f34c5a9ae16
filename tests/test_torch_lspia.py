"""Port parity for LSPIA: ``repro_torch.core.lspia`` and
``api.fit(method="lspia")`` against ``repro.core.lspia`` and ``repro.api``
on the same numpy inputs, on the CPU.

Both run the same Richardson / heavy-ball recurrence; the reference in a
``while_loop``, the port in a Python loop that reads the live flag back
once per sweep.  Tolerances:

* ``tol=0, max_iter=50``: exactly 50 sweeps on both sides (tol=0 is
  floored at 25·eps, which degrees 3 and 7 cannot reach in 50 sweeps at
  this κ; degree 1 can, and is held at the default tol); the iterate
  errors of two roundings grow at most linearly in the sweep count
  through a contraction, so coefficients agree to 1e-4 (f32) / 1e-11
  (f64) of max|c|;
* default tol: the stop depends on rounding through ``any(live)``, so the
  converged flags agree and the sweep counts differ by at most
  max(2, 2%); the coefficients then agree to the stopping tolerance
  scaled by κ ≈ 54: 2e-3 (f32) / 1e-6 (f64) of max|c|;
* the matrix-free helpers (Vᵀr, trace): rtol 1e-5 (f32) / 1e-12 (f64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import core as jcore
from repro.core import lspia as jlspia
from repro.core import moments as jmoments
from repro_torch import api, core, engine, interop
from repro_torch.core import lspia

torch.set_num_threads(1)

CPU = "cpu"
DTYPES = [np.float32, np.float64]
FIXED_TOL = {np.float32: 1e-4, np.float64: 1e-11}
CONV_TOL = {np.float32: 2e-3, np.float64: 1e-6}
HELPER_RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _x64(npd):
    return jax.enable_x64(npd == np.float64)


def _data(seed, shape, degree, npd):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, shape)
    c = rng.normal(0.0, 1.0, degree + 1)
    y = np.polyval(c[::-1], x) + 0.05 * rng.normal(size=shape)
    return x.astype(npd), y.astype(npd)


def _spec(degree, **opts):
    # the pinned domain maps [-2, 2] to [-1, 1], where κ stays small
    return japi.FitSpec(degree=degree, method="lspia", domain=(0.0, 0.5),
                        lspia=japi.LSPIAOptions(**opts))


def _both(x, y, jspec, npd, weights=None):
    with _x64(npd):
        jres = japi.fit(jnp.asarray(x), jnp.asarray(y), jspec,
                        weights=None if weights is None
                        else jnp.asarray(weights))
        jres = dict(coeffs=np.asarray(jres.coeffs),
                    iterations=int(jres.iterations),
                    converged=np.asarray(jres.converged),
                    fb=np.asarray(jres.poly.diagnostics.fallback_used))
    tres = api.fit(x, y, interop.fit_spec(jspec), weights=weights,
                   device=CPU)
    return jres, tres


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("basis", ["monomial", "chebyshev"])
def test_matrix_free_helpers_against_reference(npd, basis):
    x, y = _data(0, (3, 257), 5, npd)
    w = np.random.default_rng(1).uniform(0.5, 1.5, x.shape).astype(npd)
    c = np.random.default_rng(2).normal(size=(3, 6)).astype(npd)
    with _x64(npd):
        jx, jy, jw = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
        want_vt = np.asarray(jlspia.vt_apply(jx, jy, 5, basis=basis))
        want_tr = np.asarray(jlspia._trace_normal(jx, jw, 5, basis))
        want_op = np.asarray(jlspia._normal_op(jx, jw, jnp.asarray(c), 5,
                                               basis))
    tx, ty, tw = (torch.from_numpy(a) for a in (x, y, w))
    got_vt = lspia.vt_apply(tx, ty, 5, basis=basis).numpy()
    got_tr = lspia._trace_normal(tx, tw, 5, basis).numpy()
    got_op = lspia._normal_op(tx, tw, torch.from_numpy(c), 5, basis).numpy()
    for got, want in ((got_vt, want_vt), (got_tr, want_tr),
                      (got_op, want_op)):
        np.testing.assert_allclose(got, want, rtol=HELPER_RTOL[npd],
                                   atol=HELPER_RTOL[npd] * np.abs(want).max())
    with pytest.raises(ValueError):
        lspia.vt_apply(tx, ty, 2, basis="legendre")


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("degree", [3, 7])
@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_fixed_sweeps_agree(npd, degree, momentum):
    x, y = _data(degree, (4, 300), degree, npd)
    jres, tres = _both(x, y, _spec(degree, tol=0.0, max_iter=50,
                                   momentum=momentum), npd)
    assert jres["iterations"] == tres.iterations == 50
    scale = max(1.0, np.abs(jres["coeffs"]).max())
    np.testing.assert_allclose(tres.coeffs.numpy(), jres["coeffs"],
                               atol=FIXED_TOL[npd] * scale)


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("degree", [1, 3])
@pytest.mark.parametrize("momentum", [0.0, 0.5])
def test_default_tol_converges_alike(npd, degree, momentum):
    x, y = _data(10 + degree, (3, 400), degree, npd)
    jres, tres = _both(x, y, _spec(degree, momentum=momentum), npd)
    np.testing.assert_array_equal(tres.converged.numpy(), jres["converged"])
    assert jres["converged"].all()
    gap = abs(tres.iterations - jres["iterations"])
    assert gap <= max(2, 0.02 * jres["iterations"]), (tres.iterations,
                                                      jres["iterations"])
    scale = max(1.0, np.abs(jres["coeffs"]).max())
    np.testing.assert_allclose(tres.coeffs.numpy(), jres["coeffs"],
                               atol=CONV_TOL[npd] * scale)
    # the LSPIA fixed point is the LSE fit
    lse = api.fit(x, y, api.FitSpec(degree=degree, domain=(0.0, 0.5)),
                  device=CPU)
    np.testing.assert_allclose(tres.coeffs.numpy(), lse.coeffs.numpy(),
                               atol=CONV_TOL[npd] * scale)


@pytest.mark.parametrize("npd", DTYPES)
def test_weights_decay_ridge_and_init(npd):
    x, y = _data(5, (2, 500), 3, npd)
    w = np.random.default_rng(6).uniform(0.0, 2.0, x.shape).astype(npd)
    jspec = japi.FitSpec(degree=3, method="lspia", decay=0.995, ridge=0.5,
                         numerics=japi.NumericsPolicy(normalize=True),
                         lspia=japi.LSPIAOptions(tol=0.0, max_iter=40,
                                                 momentum=0.3))
    jres, tres = _both(x, y, jspec, npd, weights=w)
    assert tres.iterations == jres["iterations"] == 40
    scale = max(1.0, np.abs(jres["coeffs"]).max())
    np.testing.assert_allclose(tres.coeffs.numpy(), jres["coeffs"],
                               atol=FIXED_TOL[npd] * scale)
    # an explicit start and step through the legacy shim
    init = np.full((2, 4), 0.1, npd)
    with _x64(npd):
        jf = jlspia.lspia_fit(jnp.asarray(x), jnp.asarray(y), 3,
                              weights=jnp.asarray(w), step=1e-3, tol=0.0,
                              max_iter=30, init=jnp.asarray(init))
        jc = np.asarray(jf.poly.coeffs)
        jstep = np.asarray(jf.step)
    tf = lspia.lspia_fit(x, y, 3, weights=w, step=1e-3, tol=0.0,
                         max_iter=30, init=init, device=CPU)
    assert tf.iterations == 30
    np.testing.assert_allclose(tf.step.numpy(), jstep)
    np.testing.assert_allclose(tf.poly.coeffs.numpy(), jc,
                               atol=FIXED_TOL[npd]
                               * max(1.0, np.abs(jc).max()))


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("opts", [dict(tol=0.0, max_iter=50),
                                  dict(momentum=0.5),
                                  dict(tol=0.0, max_iter=50, step=2e-3)])
def test_solve_moments_against_reference(npd, opts):
    x, y = _data(7, (5, 200), 3, npd)
    xt = 0.5 * x
    with _x64(npd):
        jm = jmoments.gram_moments(jnp.asarray(xt), jnp.asarray(y), 3)
        gram, vty = np.array(jm.gram), np.array(jm.vty)
        gram[4] = 0.0                 # an idle slot: all-zero state
        vty[4] = 0.0
        jc, jcond, jconv, jit = (np.asarray(a) for a in
                                 jlspia.lspia_solve_moments(
                                     jnp.asarray(gram), jnp.asarray(vty),
                                     **opts))
    tc, tcond, tconv, tit = lspia.lspia_solve_moments(
        torch.from_numpy(gram), torch.from_numpy(vty), **opts)
    np.testing.assert_array_equal(tconv.numpy(), jconv)
    if opts.get("tol", 1) == 0.0:
        assert tit == int(jit) == 50
        tol = FIXED_TOL[npd]
    else:
        assert abs(tit - int(jit)) <= max(2, 0.02 * int(jit))
        tol = CONV_TOL[npd]
    scale = max(1.0, np.abs(jc).max())
    np.testing.assert_allclose(tc.numpy(), jc, atol=tol * scale)
    # the idle slot converges at once to c = 0
    assert bool(tconv[4]) and not tc[4].any()
    assert tcond.shape == jcond.shape


def test_guards_keep_coefficients_finite():
    """The settledness-gated step clamp and the divergence freeze: an
    adversarial spectrum (99% of the mass at one point) stays finite at
    every power-iteration count, and an oversized step freezes, reports
    converged=False, and stays finite, as in the reference."""
    rng = np.random.default_rng(11)
    x = np.concatenate([np.full(4000, 2.0), rng.uniform(-3, 3, 40)])
    y = 0.5 * x ** 2 - x + 0.3 + 0.01 * rng.normal(size=x.size)
    xf, yf = x.astype(np.float32), y.astype(np.float32)
    for piters in (1, 2, 12):
        f = lspia.lspia_fit(xf, yf, 4, power_iters=piters, max_iter=200,
                            device=CPU)
        jf = jlspia.lspia_fit(jnp.asarray(xf), jnp.asarray(yf), 4,
                              power_iters=piters, max_iter=200)
        assert bool(torch.isfinite(f.poly.coeffs).all())
        assert bool(f.converged) == bool(jf.converged)
    f = lspia.lspia_fit(xf, yf, 4, step=1e6, max_iter=50, device=CPU)
    jf = jlspia.lspia_fit(jnp.asarray(xf), jnp.asarray(yf), 4, step=1e6,
                          max_iter=50)
    assert bool(torch.isfinite(f.poly.coeffs).all())
    assert not bool(f.converged) and not bool(jf.converged)
    assert bool(f.poly.diagnostics.fallback_used)
    np.testing.assert_allclose(f.poly.coeffs.numpy(),
                               np.asarray(jf.poly.coeffs), rtol=1e-5,
                               atol=1e-6)


def test_nonconvergence_is_flagged_and_polyfit_front_door():
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 2, 512).astype(np.float32)
    y = rng.normal(0, 1, 512).astype(np.float32)
    lf = core.lspia_fit(x, y, 9, max_iter=50, device=CPU)
    jlf = jcore.lspia_fit(jnp.asarray(x), jnp.asarray(y), 9, max_iter=50)
    assert not bool(lf.converged) and not bool(jlf.converged)
    assert bool(lf.poly.diagnostics.fallback_used)
    assert float(lf.poly.diagnostics.condition) > 30.0
    assert lf.poly.diagnostics.solver == "lspia"
    # polyfit(..., solver="lspia") runs the same method on the normalized
    # domain, as the reference's shim spells it
    x3, y3 = _data(8, (300,), 3, np.float32)
    poly = core.polyfit(x3, y3, 3, solver="lspia", device=CPU)
    jpoly = jcore.polyfit(jnp.asarray(x3), jnp.asarray(y3), 3,
                          solver="lspia")
    assert poly.diagnostics.solver == "lspia"
    np.testing.assert_allclose(float(poly.domain_scale),
                               float(jpoly.domain_scale), rtol=1e-6)
    np.testing.assert_allclose(poly.coeffs.numpy(), np.asarray(jpoly.coeffs),
                               atol=CONV_TOL[np.float32]
                               * max(1.0, np.abs(jpoly.coeffs).max()))


@pytest.mark.parametrize("backend,path", [("cpu", "reference"),
                                          ("cuda", "reference")])
def test_lspia_workload_plans_the_matrix_free_path(backend, path):
    spec = api.FitSpec(degree=3, method="lspia")
    p = engine.plan_fit((4096, 65536), 3, workload="lspia", device=CPU,
                        backend=backend)
    assert p.path == path and p.numerics.solver == "lspia"
    assert p.numerics.fallback is None and "matrix-free" in p.reason
    assert spec.plan((4, 100), torch.float32, workload="lspia",
                     device=CPU).path == "reference"
    # a forced kernel engine is validated all the same
    with pytest.raises(ValueError, match="monomial"):
        engine.plan_fit((4, 100), 3, workload="lspia", engine="kernel",
                        basis="chebyshev")
