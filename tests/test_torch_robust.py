"""Port parity for IRLS: ``repro_torch.core.robust`` and
``api.fit(method="irls")`` against ``repro.core.robust`` and
``repro.api`` on the same numpy inputs, on the CPU.

Series have an EVEN number of points, so the median of the residuals is
the mean of two middle values: ``torch.nanmedian`` would return the lower
one, the reference's ``jnp.nanmedian`` the mean, and the MAD scale and
every weight after it would differ.  Tolerances:

* ``chunk_scale`` and the weights: rtol 1e-6 in float32, 1e-12 in
  float64 (the same sort and the same two-term mean on both sides);
* coefficients: atol 2e-4 in float32 (each IRLS step re-solves a
  weighted Gram in its own LAPACK; the loop stops at tol = 500·eps ≈
  6e-5 relative coefficient change), 1e-9 in float64;
* iterations: equal in float64, within one in float32, where a step that
  lands near the stopping tolerance may fall on either side of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import robust as jrobust
from repro_torch import api, core, engine, interop
from repro_torch.core import robust

torch.set_num_threads(1)

CPU = "cpu"
DTYPES = [np.float32, np.float64]
RTOL = {np.float32: 1e-6, np.float64: 1e-12}
ATOL = {np.float32: 2e-4, np.float64: 1e-9}


def _contaminated(seed, shape, frac=0.15):
    """A cubic with N(0, 0.05²) noise and ``frac`` of the points thrown
    off by ±(2..5)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    y = 0.5 - x + 0.8 * x ** 3 + 0.05 * rng.normal(size=shape)
    bad = rng.uniform(size=shape) < frac
    y = np.where(bad, y + rng.choice([-1, 1], shape)
                 * rng.uniform(2, 5, shape), y)
    return x, y


def _x64(npd):
    return jax.enable_x64(npd == np.float64)


@pytest.mark.parametrize("npd", DTYPES)
def test_chunk_scale_even_length_masked_and_all_masked(npd):
    rng = np.random.default_rng(1)
    r = rng.normal(size=(4, 10)).astype(npd)
    y = rng.normal(size=(4, 10)).astype(npd)
    w = (rng.uniform(size=(4, 10)) > 0.3).astype(npd)
    w[1, :] = 1.0                  # ten live points: an even count
    w[2, :] = 0.0                  # all masked: σ̂ pinned to the floor
    w[3, :4] = 0.0                 # six live points
    with _x64(npd):
        want = np.asarray(jrobust.chunk_scale(jnp.asarray(r), jnp.asarray(w),
                                              jnp.asarray(y)))
    got = robust.chunk_scale(torch.from_numpy(r), torch.from_numpy(w),
                             torch.from_numpy(y))
    assert got.shape == (4, 1) and got.dtype == torch.from_numpy(r).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[npd])
    assert float(got[2, 0]) == pytest.approx(float(np.finfo(npd).eps))
    # the trap: torch.nanmedian takes the lower middle value
    lower = 1.4826 * torch.nanmedian(torch.from_numpy(np.abs(r[1])))
    assert abs(float(lower) - float(want[1, 0])) > 1e-3


@pytest.mark.parametrize("npd", DTYPES)
def test_robust_weights_against_reference(npd):
    u = np.linspace(-8, 8, 161).astype(npd)
    ids = (np.arange(161) % 2).astype(np.int32)
    c = np.where(ids == 1, 4.685, 1.345).astype(npd)
    for loss, cval in (("huber", 1.345), ("tukey", 4.685)):
        with _x64(npd):
            want = np.asarray(jrobust.robust_weights(jnp.asarray(u), loss,
                                                     cval))
        got = robust.robust_weights(torch.from_numpy(u), loss, cval)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[npd])
    with _x64(npd):
        want = np.asarray(jrobust.robust_weights_by_id(
            jnp.asarray(u), jnp.asarray(ids), jnp.asarray(c)))
    got = robust.robust_weights_by_id(torch.from_numpy(u),
                                      torch.from_numpy(ids),
                                      torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[npd])
    with pytest.raises(ValueError):
        robust.robust_weights(torch.from_numpy(u), "cauchy", 1.0)
    with pytest.raises(ValueError):
        robust.resolve_tuning("cauchy", None)
    assert robust.resolve_tuning("tukey", None) == 4.685


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_irls_fit_against_reference(npd, loss):
    x, y = _contaminated(2 + (loss == "tukey"), (3, 400))
    x, y = x.astype(npd), y.astype(npd)
    rng = np.random.default_rng(4)
    w = (rng.uniform(size=x.shape) > 0.05).astype(npd)   # base weights
    jspec = japi.FitSpec(degree=3, method="irls",
                         irls=japi.IRLSOptions(loss=loss))
    with _x64(npd):
        jfit, jw = jrobust.irls_fit(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(w), jspec)
        jc = np.asarray(jfit.poly.coeffs)
        jit = int(jfit.iterations)
        jconv = np.asarray(jfit.converged)
        jscale = np.asarray(jfit.scale)
        jw = np.asarray(jw)
    engine.reset_moment_counter()
    tfit, tw = robust.irls_fit(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(w), interop.fit_spec(jspec))
    # one weighted moment pass for the LSE start and one per iteration
    assert engine.moment_counter()["calls"] == tfit.iterations + 1
    np.testing.assert_allclose(tfit.poly.coeffs.double().numpy(), jc,
                               atol=ATOL[npd], rtol=0)
    if npd == np.float64:
        assert tfit.iterations == jit
    else:
        assert abs(tfit.iterations - jit) <= 1
    np.testing.assert_array_equal(tfit.converged.numpy(), jconv)
    np.testing.assert_allclose(tfit.scale.double().numpy(), jscale,
                               rtol=50 * ATOL[npd])
    assert tw.shape == x.shape
    np.testing.assert_array_equal(tw.numpy() == 0, jw == 0)
    # the planted cubic, through 15% gross outliers
    np.testing.assert_allclose(tfit.poly.coeffs.double().numpy(),
                               np.tile([0.5, -1.0, 0.0, 0.8], (3, 1)),
                               atol=0.05)


@pytest.mark.parametrize("kw", [dict(), dict(ridge=1e-3), dict(decay=0.999),
                                dict(numerics=dict(normalize=True)),
                                dict(irls=dict(loss="tukey", max_iter=2))])
def test_api_fit_irls_against_reference(kw):
    kw = dict(kw)
    num = kw.pop("numerics", {})
    irls = kw.pop("irls", {})
    x, y = _contaminated(5, (2, 300))
    jspec = japi.FitSpec(degree=3, method="irls",
                         irls=japi.IRLSOptions(**irls),
                         numerics=japi.NumericsPolicy(solver="auto", **num),
                         **kw)
    with _x64(np.float64):
        jres = japi.fit(jnp.asarray(x), jnp.asarray(y), jspec)
        jc = np.asarray(jres.coeffs)
        jit = int(jres.iterations)
        jconv = np.asarray(jres.converged)
    tres = api.fit(x, y, interop.fit_spec(jspec), device=CPU)
    np.testing.assert_allclose(tres.coeffs.numpy(), jc, atol=1e-9, rtol=0)
    assert tres.iterations == jit
    np.testing.assert_array_equal(tres.converged.numpy(), jconv)
    assert tres.report is None and tres.selection is None


def test_robust_polyfit_shim_and_clean_data():
    x, y = _contaminated(6, (256,), frac=0.0)
    with _x64(np.float64):
        jfit = jrobust.robust_polyfit(jnp.asarray(x), jnp.asarray(y), 3,
                                      loss="huber")
        jc = np.asarray(jfit.poly.coeffs)
    tfit = core.robust_polyfit(x, y, 3, loss="huber", device=CPU)
    np.testing.assert_allclose(tfit.poly.coeffs.numpy(), jc, atol=1e-9)
    # with no contamination IRLS stays at the plain LSE fit
    lse = core.polyfit(x, y, 3, device=CPU)
    np.testing.assert_allclose(tfit.poly.coeffs.numpy(), lse.coeffs.numpy(),
                               atol=5e-3)
    with pytest.raises(ValueError):
        core.robust_polyfit(x, y, 3, loss="cauchy", device=CPU)
