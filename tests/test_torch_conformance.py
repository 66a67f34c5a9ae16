"""Port parity: the conformance matrix of the reference's conformance
suite, degrees 1-9 × f32/f64 × monomial/Chebyshev × identity/normalized,
``repro_torch.api.fit`` (CPU) against ``repro.api.fit``.

Both fits minimize the same Σe², so their fitted values agree to
~eps·√κ(Gram) relative: the tolerance is twice the reference suite's
κ-scaled value tolerance max(200·eps·√κ, 50·eps), with κ the port's own
condition estimate.  Fitted values are evaluated from each fit's
coefficients and domain in float64 numpy, so the comparison is of the
fits, not of two evaluators."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.polynomial import chebyshev, polynomial

from repro import api as japi
from repro_torch import api

torch.set_num_threads(1)

CPU = "cpu"


def _values(poly, x):
    """f(x) in float64 from a fit's coefficients, basis and domain."""
    c = np.asarray(poly.coeffs, np.float64)
    t = ((x.astype(np.float64) - float(poly.domain_shift))
         * float(poly.domain_scale))
    ev = polynomial.polyval if poly.basis == "monomial" else chebyshev.chebval
    return ev(t, c)


def _conf_data(seed, n, degree, noise=0.02):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1.5, 1.5, n))
    coeffs = rng.normal(0.0, 1.0, degree + 1)
    return x, np.polyval(coeffs[::-1], x) + noise * rng.normal(0, 1, n)


@pytest.mark.parametrize("degree", range(1, 10))
@pytest.mark.parametrize("npd", [np.float32, np.float64])
def test_conformance_matrix_against_reference(degree, npd):
    x, y = _conf_data(degree + (100 if npd == np.float64 else 0), 256,
                      degree)
    x, y = x.astype(npd), y.astype(npd)
    eps = float(np.finfo(npd).eps)
    for basis in ("monomial", "chebyshev"):
        for normalize in (False, True):
            spec_kw = dict(basis=basis, normalize=normalize)
            with jax.enable_x64(npd == np.float64):
                jres = japi.fit(jnp.asarray(x), jnp.asarray(y),
                                japi.spec_from_legacy(degree, **spec_kw))
                jvals = _values(jres.poly, x)
                jsolver = jres.poly.diagnostics.solver
                jscale = float(jres.poly.domain_scale)
            tres = api.fit(x, y, api.spec_from_legacy(degree, **spec_kw),
                           device=CPU)
            tvals = _values(tres.poly, x)
            cond = float(tres.diagnostics.condition)
            assert np.isfinite(cond) and cond >= 1.0
            assert tres.diagnostics.solver == jsolver
            np.testing.assert_allclose(float(tres.poly.domain_scale), jscale,
                                       rtol=1e-6)
            tol = 2 * max(200.0 * eps * np.sqrt(cond), 50.0 * eps)
            gap = (np.linalg.norm(tvals - jvals)
                   / (np.linalg.norm(jvals) + 1e-30))
            assert gap <= tol, (basis, normalize, gap, tol, cond)
