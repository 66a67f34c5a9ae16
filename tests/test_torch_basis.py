"""Port parity: ``repro_torch.core.basis`` against ``repro.core.basis``.

Same seeded numpy inputs through both packages on the CPU.  Tolerances:
f32 rtol 1e-6 (same arithmetic, same order; only fused multiply-adds may
differ), f64 rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as jb
from repro_torch.core import basis as tb

torch.set_num_threads(1)

DTYPES = [("f32", np.float32, torch.float32, 1e-6),
          ("f64", np.float64, torch.float64, 1e-12)]


def _x(seed, shape, lo=-3.0, hi=5.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


@pytest.mark.parametrize("name,npd,td,rtol", DTYPES)
def test_domain_from_data_and_identity(name, npd, td, rtol):
    x = _x(0, (3, 17)).astype(npd)
    with jax.enable_x64(npd == np.float64):
        jd = jb.Domain.from_data(jnp.asarray(x))
        jt = np.asarray(jd.apply(jnp.asarray(x)))
    td_ = tb.Domain.from_data(torch.from_numpy(x))
    assert td_.shift.dtype == td and td_.shift.ndim == 0
    np.testing.assert_allclose(float(td_.shift), float(jd.shift), rtol=rtol)
    np.testing.assert_allclose(float(td_.scale), float(jd.scale), rtol=rtol)
    np.testing.assert_allclose(td_.apply(torch.from_numpy(x)).numpy(), jt,
                               rtol=rtol, atol=rtol)
    ident = tb.Domain.identity(td)
    assert float(ident.shift) == 0.0 and float(ident.scale) == 1.0


def test_domain_degenerate_range_keeps_unit_scale():
    x = np.full((2, 5), 3.5, np.float32)
    d = tb.Domain.from_data(torch.from_numpy(x))
    assert float(d.scale) == 1.0 and float(d.shift) == 3.5
    assert float(jb.Domain.from_data(jnp.asarray(x)).scale) == 1.0


@pytest.mark.parametrize("basis", [tb.MONOMIAL, tb.CHEBYSHEV])
@pytest.mark.parametrize("name,npd,td,rtol", DTYPES)
def test_vandermonde(basis, name, npd, td, rtol):
    x = _x(1, (2, 11), -1.0, 1.0).astype(npd)
    with jax.enable_x64(npd == np.float64):
        ref = np.asarray(jb.vandermonde(jnp.asarray(x), 6, basis))
    got = tb.vandermonde(torch.from_numpy(x), 6, basis)
    assert got.shape == (2, 11, 7) and got.dtype == td
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=rtol)


def test_vandermonde_rejects_bad_input():
    with pytest.raises(ValueError):
        tb.vandermonde(torch.zeros(3), 2, "legendre")
    with pytest.raises(ValueError):
        tb.vandermonde(torch.zeros(3), -1)


@pytest.mark.parametrize("basis", [tb.MONOMIAL, tb.CHEBYSHEV])
@pytest.mark.parametrize("name,npd,td,rtol", DTYPES)
@pytest.mark.parametrize("batched", [False, True])
def test_evaluate(basis, name, npd, td, rtol, batched):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.5, 1.5, (3, 13)).astype(npd)
    c = rng.normal(size=((3, 5) if batched else (5,))).astype(npd)
    with jax.enable_x64(npd == np.float64):
        dom = jb.Domain(jnp.asarray(0.25, npd), jnp.asarray(0.8, npd))
        ref = np.asarray(jb.evaluate(jnp.asarray(c), jnp.asarray(x),
                                     basis=basis, domain=dom))
    tdom = tb.Domain(torch.tensor(0.25, dtype=td), torch.tensor(0.8, dtype=td))
    got = tb.evaluate(torch.from_numpy(c), torch.from_numpy(x), basis=basis,
                      domain=tdom)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol * 10,
                               atol=rtol * 10)


@pytest.mark.parametrize("name,npd,td,rtol", DTYPES)
def test_monomial_coeffs_from_domain(name, npd, td, rtol):
    c = np.random.default_rng(3).normal(size=5).astype(npd)
    with jax.enable_x64(npd == np.float64):
        dom = jb.Domain(jnp.asarray(1.5, npd), jnp.asarray(0.4, npd))
        ref = np.asarray(jb.monomial_coeffs_from_domain(jnp.asarray(c), dom,
                                                        4))
    got = tb.monomial_coeffs_from_domain(
        torch.from_numpy(c),
        tb.Domain(torch.tensor(1.5, dtype=td), torch.tensor(0.4, dtype=td)),
        4)
    assert got.dtype == td
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=rtol)


# ------------------------------------------------------- the one domain rule
def _inline_rule(x, normalize, pinned):
    """The rule as each caller wrote it inline before ``Domain.choose``:
    the data's domain (or the identity) computed, then the pin over it."""
    default = (tb.Domain.from_data(x) if normalize
               else tb.Domain.identity(x.dtype, x.device))
    return default if pinned is None else pinned


@pytest.mark.parametrize("td", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["pinned", "normalize", "neither"])
def test_domain_choose_is_the_inline_rule(case, td):
    """The pin, else the data's domain under normalize, else the
    identity; the data are read (``from_data``) only when nothing is
    pinned."""
    x = torch.from_numpy(_x(2, (3, 17))).to(td)
    pinned = (tb.Domain(torch.tensor(0.5, dtype=td),
                        torch.tensor(0.25, dtype=td))
              if case == "pinned" else None)
    normalize = case != "neither"
    calls = []

    def from_data(xin):
        calls.append(xin)
        return tb.Domain.from_data(xin)

    want = _inline_rule(x, normalize, pinned)
    for kw in ({}, {"from_data": from_data}):
        got = tb.Domain.choose(x, normalize=normalize, pinned=pinned, **kw)
        assert torch.equal(got.shift, want.shift)
        assert torch.equal(got.scale, want.scale)
        assert (got.shift.dtype, got.shift.ndim) == (td, 0)
    assert len(calls) == (case == "normalize")
    assert all(c is x for c in calls)


def _surface_fit(surface, x, y, domain):
    """One fit of ``surface`` under ``normalize=True``, with ``domain``
    pinned (None: nothing pinned); its coefficients."""
    from repro_torch import api
    from repro_torch.core import distributed
    from repro_torch.engine.plan import NumericsPolicy
    method = {"fit": "lse", "irls": "irls"}.get(surface, "lspia")
    spec = api.FitSpec(degree=3, method=method, domain=domain,
                       numerics=NumericsPolicy(normalize=True),
                       lspia=api.LSPIAOptions(max_iter=60))
    if surface == "async_lspia":
        return distributed.async_lspia_fit(x[0], y[0], spec, n_shards=2,
                                           device="cpu").poly.coeffs
    return api.fit(x, y, spec, device="cpu").poly.coeffs


@pytest.mark.parametrize("pinned", [True, False])
@pytest.mark.parametrize("surface", ["fit", "irls", "lspia", "async_lspia"])
def test_each_surface_reads_the_data_only_when_nothing_is_pinned(
        monkeypatch, surface, pinned):
    """Under ``normalize=True``: with a domain pinned, no surface calls
    ``Domain.from_data``; with none pinned, it calls it once, and its
    coefficients are bit-equal to the same fit with that data domain
    pinned."""
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.uniform(-3.0, 5.0, (2, 300)).astype(np.float32))
    y = 1.0 - 0.5 * x + 0.1 * x ** 3 + torch.from_numpy(
        rng.normal(0.0, 0.1, x.shape).astype(np.float32))
    data_dom = tb.Domain.from_data(x[0] if surface == "async_lspia" else x)
    calls = []
    real = tb.Domain.from_data

    def spy(xin):
        calls.append(xin)
        return real(xin)

    monkeypatch.setattr(tb.Domain, "from_data", staticmethod(spy))
    if pinned:
        _surface_fit(surface, x, y, (0.5, 0.25))
        assert calls == []
        return
    got = _surface_fit(surface, x, y, None)
    assert len(calls) == 1
    want = _surface_fit(surface, x, y,
                        (float(data_dom.shift), float(data_dom.scale)))
    assert len(calls) == 1
    assert torch.equal(got, want)
