"""``api.fit(method="irls")`` against the benchmark's plain float64 IRLS
reference (``perfbench/reference/irls.py``, plain PyTorch, loaded by
path), on the CPU, at a small size of the ``robust.tukey`` cell's
traffic: 16 series of 4096 points, x ~ U(-2, 2), each series its own
N(0, 1) cubic plus N(0, 0.05²) noise, a fifth of the points thrown off
by ±50.

Bounds, with their reasons:

* the program's answer against the reference: the relative excess
  weighted SSE at the reference's final weights at or under the cell's
  own limit (``perfbench/limits/robust.tukey.json``), and every series
  converged.  The program stops at a coefficient change of 500·eps
  (float32) where the reference iterates to its fixed point, so the
  two differ by that stopping error and float32's rounding: ≈ 1e-8 at
  this size, ≈ 6e-8 at the cell's on the card, against a bfloat16
  control's ≈ 2 here and ≈ 10 there;
* the reference against the planted cubic: a relative coefficient error
  under 0.05, the upstream robust row's own bound (``benchmarks/run.py``
  row ``irls``), where plain least squares misses by at least ten times
  as much: the outliers' spread (50·√0.2 ≈ 22) over √4096 points moves
  it by ≈ 0.3, the inliers' noise moves the M-estimate by ≈ 1e-3.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
LIMITS = json.loads((BENCH / "limits" / "robust.tukey.json").read_text())
B, N = 16, 4096


def _reference():
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_irls", BENCH / "reference" / "irls.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


irls = _reference()


def _contaminated(seed):
    """The cell's traffic at (B, N), float32, and the planted cubics."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, N, generator=g) * 4 - 2
    coef = torch.randn(B, 4, generator=g)
    y = coef[:, 3:] * x ** 3 + coef[:, 2:3] * x ** 2 + coef[:, 1:2] * x \
        + coef[:, :1]
    y = y + 0.05 * torch.randn(B, N, generator=g)
    bad = torch.rand(B, N, generator=g) < 0.2
    up = torch.rand(B, N, generator=g) < 0.5
    y = y + torch.where(bad, torch.where(up, 50.0, -50.0), 0.0)
    return x, y, coef.double()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("loss", ["tukey", "huber"])
def test_irls_fit_against_the_plain_reference(loss, seed):
    x, y, _ = _contaminated(seed)
    spec = api.FitSpec(degree=3, method="irls",
                       irls=api.IRLSOptions(loss=loss))
    res = api.fit(x, y, spec, device="cpu")
    # a float32 cubic is fitted in the raw variable, as the reference
    assert float(res.poly.domain_shift) == 0.0
    assert float(res.poly.domain_scale) == 1.0
    ref = irls.fit(x, y, 3, loss)
    assert bool(ref.converged.all())
    assert bool(res.converged.all())
    ex = irls.excess(ref, res.poly.coeffs)
    assert float(ex.max()) <= LIMITS["sse_excess"], ex
    assert float(ex.min()) >= 0.0


def _rel(c, true):
    return (torch.linalg.vector_norm(c.double() - true, dim=-1)
            / torch.linalg.vector_norm(true, dim=-1))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_reference_recovers_the_planted_cubic(seed):
    x, y, true = _contaminated(seed)
    robust = _rel(irls.fit(x, y, 3, "tukey").coeffs, true)
    v = np.polynomial.polynomial.polyvander(x.double().numpy(), 3)
    plain = torch.from_numpy(np.stack([
        np.linalg.lstsq(v[i], y[i].double().numpy(), rcond=None)[0]
        for i in range(B)]))
    lse = _rel(plain, true)
    assert float(robust.max()) < 0.05, robust
    assert bool((lse >= 10.0 * robust).all()), (lse, robust)


def test_the_program_keeps_the_bits_it_had_without_a_profiler():
    """A fit under the profiler, with the IRLS phase spans on, returns
    the bits of a fit without one."""
    from torch.profiler import ProfilerActivity, profile
    x, y, _ = _contaminated(2)
    spec = api.FitSpec(degree=3, method="irls",
                       irls=api.IRLSOptions(loss="tukey"))
    plain = api.fit(x, y, spec, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced = api.fit(x, y, spec, device="cpu")
    assert torch.equal(plain.poly.coeffs, traced.poly.coeffs)
    assert plain.iterations == traced.iterations
    assert torch.equal(plain.converged, traced.converged)
