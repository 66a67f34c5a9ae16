"""Port parity for the slice as a whole: ``repro_torch.core.fit`` and
``repro_torch.api`` against the JAX reference and the paper's tables, on
the CPU (``device="cpu"``).

* The paper's Tables II-V in float64 (constants copied from the
  reference's paper-table suite: order 1-3 coefficients, Σe² = 128.1999,
  the Table V fitted values).
* Weights, decay, ridge and the QR baseline, the reports, interop, the
  device rule and the scope of this slice (the conformance matrix is in
  ``test_torch_conformance.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import core as jcore
from repro_torch import api, core, interop
from repro_torch.kernels import ops

torch.set_num_threads(1)

CPU = "cpu"
X64 = [39.206, 29.74, 21.31, 12.087, 1.812, 0.001]
Y64 = [751.912, 567.121, 403.746, 221.738, 18.8418, 1.88672]
PAPER_POLYFIT = {
    1: [-8.356, 19.3496],
    2: [-6.5109, 18.8735, 0.0127],
    3: [-4.7551, 17.5109, 0.1086, -0.0016],
}
PAPER_SSE_F = 128.199937
PAPER_FITTED_ORDER3 = [751.18396, 569.500305, 402.053284, 219.903793,
                       27.321678, -4.736779]


def _paper(dtype=torch.float64):
    return (torch.tensor(X64, dtype=dtype), torch.tensor(Y64, dtype=dtype))


# ------------------------------------------------------------ paper tables
@pytest.mark.parametrize("order", [1, 2, 3])
def test_paper_coefficients_tables_ii_iv(order):
    x, y = _paper()
    poly = core.polyfit(x, y, order, device=CPU)
    np.testing.assert_allclose(poly.coeffs.numpy(), PAPER_POLYFIT[order],
                               atol=2.5e-4)
    qr = core.polyfit(x, y, order, solver="qr_vandermonde", device=CPU)
    np.testing.assert_allclose(poly.coeffs.numpy(), qr.coeffs.numpy(),
                               rtol=1e-8, atol=1e-10)
    with pytest.warns(DeprecationWarning):
        shim = core.polyfit_qr(x, y, order, device=CPU)
    np.testing.assert_allclose(shim.coeffs.numpy(), qr.coeffs.numpy())


def test_paper_table_v_sse_fitted_and_r():
    x, y = _paper()
    poly = core.polyfit(x, y, 3, device=CPU)
    rep = core.fit_report(poly, x, y)
    assert abs(float(rep.sse) - PAPER_SSE_F) < 5e-3
    np.testing.assert_allclose(rep.fitted.numpy(), PAPER_FITTED_ORDER3,
                               atol=2e-2)
    for order in (1, 2, 3):
        r = core.fit_report(core.polyfit(x, y, order, device=CPU), x, y).r
        assert float(r) > 0.999
    # Σe² straight from the moments, no data pass
    m = core.gram_moments(x, y, 3)
    np.testing.assert_allclose(float(core.sse_from_moments(m, poly.coeffs)),
                               float(rep.sse), rtol=1e-6)


def test_paper_f32_precision_gap():
    x, y = _paper(torch.float32)
    a = core.polyfit(x, y, 3, device=CPU).coeffs.double()
    b = core.polyfit(x, y, 3, solver="qr_vandermonde", device=CPU).coeffs
    gap = float((a - b.double()).abs().max())
    assert 0 < gap < 0.5


# -------------------------------------------- weights, decay, ridge, QR
def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


@pytest.mark.parametrize("kw", [
    dict(), dict(decay=0.97), dict(ridge=0.5),
    dict(numerics=dict(solver="qr_vandermonde", fallback=None)),
    dict(numerics=dict(solver="svd")), dict(basis="chebyshev"),
    dict(numerics=dict(solver="cholesky", normalize=True)),
    dict(domain=(0.5, 0.8)),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_spec_options_against_reference(kw, weighted):
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.0, 2.0, (3, 120))
    y = 1.0 - 2.0 * x + 0.5 * x ** 3 + 0.05 * rng.normal(size=x.shape)
    w = rng.uniform(0.0, 2.0, x.shape) * (rng.uniform(size=x.shape) > 0.2) \
        if weighted else None
    kw = dict(kw)
    num = kw.pop("numerics", {})
    with jax.enable_x64(True):
        jspec = japi.FitSpec(degree=3, numerics=japi.NumericsPolicy(
            **{"solver": "auto", **num}), **kw)
        jres = japi.fit(jnp.asarray(x), jnp.asarray(y), jspec,
                        weights=None if w is None else jnp.asarray(w))
        jc = np.asarray(jres.poly.coeffs)
        jrep = (None if jres.report is None
                else (np.asarray(jres.report.sse), np.asarray(jres.report.r)))
    tspec = interop.fit_spec(jspec)
    tres = api.fit(x, y, tspec, weights=w, device=CPU)
    assert _rel(tres.coeffs.numpy(), jc) < 1e-9
    if jrep is None:
        assert tres.report is None
    else:
        assert _rel(tres.report.sse.numpy(), jrep[0]) < 1e-8
        assert _rel(tres.report.r.numpy(), jrep[1]) < 1e-8


# -------------------------------------------------------------- reports
@pytest.mark.parametrize("basis", ["monomial", "chebyshev"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_report_and_streamed(basis, weighted):
    rng = np.random.default_rng(12)
    x = rng.uniform(-2.0, 2.0, (2, 200)).astype(np.float32)
    y = (np.sin(x) + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
    w = (rng.uniform(size=x.shape) > 0.25).astype(np.float32) \
        if weighted else None
    jpoly = jcore.polyfit(jnp.asarray(x), jnp.asarray(y), 4, basis=basis,
                          normalize=True)
    jrep = jcore.fit_report_streamed(
        jpoly, jnp.asarray(x), jnp.asarray(y),
        weights=None if w is None else jnp.asarray(w))
    jfull = jcore.fit_report(jpoly, jnp.asarray(x), jnp.asarray(y))
    tpoly = interop.polynomial(jpoly, CPU)
    trep = core.fit_report_streamed(tpoly, x, y, weights=w, device=CPU)
    np.testing.assert_allclose(trep.sse.numpy(), np.asarray(jrep.sse),
                               rtol=1e-4)
    np.testing.assert_allclose(trep.r.numpy(), np.asarray(jrep.r), rtol=1e-5)
    np.testing.assert_allclose(trep.count.numpy(), np.asarray(jrep.count))
    tfull = core.fit_report(tpoly, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tfull.sse.numpy(), np.asarray(jfull.sse),
                               rtol=1e-4)
    np.testing.assert_allclose(tfull.r.numpy(), np.asarray(jfull.r),
                               rtol=1e-5)
    if not weighted:   # the one-pass report equals the materializing one
        np.testing.assert_allclose(trep.sse.numpy(), tfull.sse.numpy(),
                                   rtol=1e-4)


def test_report_from_moments_matches_reference():
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (3, 80))
    y = x ** 2 + 0.1 * rng.normal(size=x.shape)
    with jax.enable_x64(True):
        jm = jcore.gram_moments(jnp.asarray(x), jnp.asarray(y), 2)
        cn = rng.normal(size=(3, 3))
        c = jnp.asarray(cn)
        jrep = jcore.report_from_moments(jm, c)
        jsse = np.asarray(jcore.sse_from_moments(jm, c))
        tm = interop.moments(jm, CPU)
        trep = core.report_from_moments(tm, torch.from_numpy(cn))
        np.testing.assert_allclose(trep.sse.numpy(), np.asarray(jrep.sse),
                                   rtol=1e-10)
        np.testing.assert_allclose(trep.r.numpy(), np.asarray(jrep.r),
                                   rtol=1e-10)
        np.testing.assert_allclose(
            core.sse_from_moments(tm, torch.from_numpy(cn)).numpy(),
            jsse, rtol=1e-10)


# --------------------------------------------------------------- interop
def test_interop_round_trip_moments_to_coefficients():
    rng = np.random.default_rng(14)
    x = rng.uniform(-2, 2, (4, 300))
    y = 0.3 + x - 0.2 * x ** 2 + 0.05 * rng.normal(size=x.shape)
    with jax.enable_x64(True):
        jm = jcore.gram_moments(jnp.asarray(x), jnp.asarray(y), 2)
        jpoly = jcore.fit_from_moments(jm)
        jc = np.asarray(jpoly.coeffs)
        jcond = np.asarray(jpoly.diagnostics.condition)
        jdom = jcore.Domain.from_data(jnp.asarray(x))
    tm = interop.moments(jm, CPU)
    tpoly = core.fit_from_moments(tm)
    np.testing.assert_allclose(tpoly.coeffs.numpy(), jc, rtol=1e-10)
    np.testing.assert_allclose(tpoly.diagnostics.condition.numpy(), jcond,
                               rtol=1e-6)
    assert tpoly.diagnostics.solver == jpoly.diagnostics.solver
    back = interop.to_numpy(tm)
    for f in interop.MOMENT_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jm, f)))
    td = interop.domain(jdom, CPU)
    assert float(td.shift) == float(jdom.shift)
    assert float(td.scale) == float(jdom.scale)
    assert interop.torch_dtype(jnp.float32) == torch.float32
    assert interop.torch_dtype(None) is None


# ----------------------------------------------------- device and scope
def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _paper()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.fit(x, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        core.polyfit(x, y, 2)
    poly = core.polyfit(x, y, 2, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        core.fit_report_streamed(poly, x, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.moments(x, y, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.fit(x, y, device="cuda")


@pytest.mark.parametrize("call", [
    lambda: api.fit([0.0, 1.0, 2.0], [1.0, 2.0, 3.0],
                    api.spec_from_legacy(1, solver="lspia"), device=CPU),
    lambda: core.polyfit([0.0, 1.0, 2.0], [1.0, 2.0, 3.0], 1,
                         method="lspia", device=CPU),
    lambda: api.fit([[0.0, 1.0, 2.0]] * 2, [[1.0, 2.0, 3.0]] * 2,
                    api.FitSpec(degree=1, method="lspia"), device=CPU),
    lambda: api.fit([0.0, 1.0, 2.0], [1.0, 2.0, 3.0],
                    api.FitSpec(degree=1, method="lspia"), device=CPU),
    lambda: core.polyfit([0.0, 1.0, 2.0], [1.0, 2.0, 3.0], 1,
                         solver="lspia", device=CPU),
])
def test_later_slices_raise_not_implemented(call):
    """Every LSPIA spelling that raised NotImplementedError before the LSPIA
    slice was ported now runs the matrix-free method on the CPU."""
    out = call()
    poly = getattr(out, "poly", out)
    assert poly.diagnostics.solver == "lspia"
    assert bool(torch.isfinite(poly.coeffs).all())


@pytest.mark.parametrize("kw", [
    dict(method="newton"), dict(basis="legendre"), dict(engine="fast"),
    dict(degree=-1), dict(decay=0.0), dict(ridge=-1.0),
    dict(engine="kernel", basis="chebyshev"),
    dict(numerics=dict(solver="lspia")),
    dict(numerics=dict(solver="qr_vandermonde"), ridge=0.1),
])
def test_spec_validation_matches_reference(kw):
    kw = dict(kw)
    num = kw.pop("numerics", None)
    with pytest.raises(ValueError):
        japi.FitSpec(**kw, **({} if num is None else
                              {"numerics": japi.NumericsPolicy(**num)}))
    with pytest.raises(ValueError):
        api.FitSpec(**kw, **({} if num is None else
                             {"numerics": api.NumericsPolicy(**num)}))
