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
