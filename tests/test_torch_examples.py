"""The port's five examples (``examples/torch_*.py``), each run with
``--device cpu`` in a subprocess (120 s limit each), their closing JSON
line held against the JAX package's functions on the same numpy inputs.

Tolerances (float32 throughout, eps = 2^-23):

* quickstart — Table I coefficients within the κ-scaled bound of
  ``tests/test_torch_conformance.py``, 2·max(200·eps·√κ, 50·eps) relative
  to max|c| (κ: the port's condition estimate of the Gram); Σe² within
  rtol 1e-4 and R within rtol 1e-5 (as ``tests/test_torch_fit.py``); the
  1M-point stream within eps·√65536·κ relative to max|c| (the random
  rounding of one 65536-point float32 chunk sum, amplified by κ).
* select_degree — the chosen degrees equal; each rung's SSE within
  64·eps·yᵀy absolute (moment-space SSE cancels terms of size yᵀy).
* serve_fits — the worst gap to the JAX package's polyfit below 1e-3 (the
  reference example's own bar); 0 new step keys after warmup, 1 per
  novel spec.
* monitors_demo — slope, prediction and the power law within rtol 1e-4
  (a float32 streaming fit with forgetting over 300 points, and a
  33-offset grid whose pick is exact), the stragglers and the re-sliced
  shares equal.
* fitspec_surfaces — the four surfaces within 1e-3 of each other (the
  streaming IRLS reweights per chunk against the running fit, three
  sweeps a chunk; the reference example prints the same spread), the
  1-rank mesh equal to eager, and eager within 1e-4 of the JAX package's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)
ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
       "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "2"}
_RUNS: dict[str, dict] = {}


def run_example(name: str) -> dict:
    """The closing JSON line of ``examples/torch_<name>.py --device cpu``
    (one run per example per process)."""
    if name not in _RUNS:
        out = subprocess.run(
            [sys.executable, str(REPO / "examples" / f"torch_{name}.py"),
             "--device", "cpu"],
            capture_output=True, text=True, cwd=REPO, env=ENV, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = out.stdout.strip().splitlines()
        _RUNS[name] = json.loads(lines[-1])
        _RUNS[name]["_stdout"] = out.stdout
    return _RUNS[name]


def _kappa_tol(kappa: float) -> float:
    return 2 * max(200.0 * EPS32 * np.sqrt(kappa), 50.0 * EPS32)


# -------------------------------------------------------------- quickstart
def test_quickstart_table_one_against_reference():
    from repro import core as jcore
    out = run_example("quickstart")
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_quickstart as ex
    finally:
        sys.path.pop(0)
    x = jnp.asarray(ex.TABLE_X, jnp.float32)
    y = jnp.asarray(ex.TABLE_Y, jnp.float32)
    for order in (1, 2, 3):
        got = out["table1"][str(order)]
        ref = jcore.polyfit(x, y, order)
        rep = jcore.fit_report(ref, x, y)
        c = np.asarray(ref.coeffs, np.float64)
        tol = _kappa_tol(got["cond"]) * np.abs(c).max()
        for key in ("coeffs", "qr"):
            np.testing.assert_allclose(got[key], c, rtol=0, atol=tol)
        np.testing.assert_allclose(got["sse"], float(rep.sse), rtol=1e-4)
        np.testing.assert_allclose(got["r"], float(rep.r), rtol=1e-5)
    # the forced kernel path (its plain version here) is the paper's fit
    assert out["kernel_coeffs"] == out["table1"]["3"]["coeffs"]
    assert out["hankel_equals_gram"] is True
    assert "Hankel(power sums) == Gram: True" in out["_stdout"]


def test_quickstart_stream_against_reference():
    import jax
    from repro.core import streaming as jstreaming
    from repro.data import curve_dataset
    out = run_example("quickstart")["stream"]
    xs, ys, true = curve_dataset(1_000_000, degree=2, noise=5.0, seed=0)
    np.testing.assert_allclose(out["true"], np.asarray(true), rtol=1e-7)
    state = jstreaming.StreamState.create(2)
    for lo in range(0, xs.shape[0], 65536):
        state = jstreaming.update(state, xs[lo:lo + 65536],
                                  ys[lo:lo + 65536])
    ref = np.asarray(jstreaming.current_fit(state).coeffs, np.float64)
    kappa = float(np.linalg.cond(np.asarray(state.moments.gram, np.float64)))
    tol = EPS32 * np.sqrt(65536) * kappa * np.abs(ref).max()
    np.testing.assert_allclose(out["coeffs"], ref, rtol=0, atol=tol)
    assert out["points"] == 1_000_000
    assert out["state_floats"] == sum(
        a.size for a in jax.tree.leaves(state))


# ----------------------------------------------------------- select_degree
def test_select_degree_against_reference():
    from repro import core as jcore
    from repro import engine as jengine
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_select_degree as ex
    finally:
        sys.path.pop(0)
    out = run_example("select_degree")
    xh, yh = ex.data()
    x, y = jnp.asarray(xh), jnp.asarray(yh)
    jengine.reset_moment_counter()
    sel = jcore.select_degree(x, y, max_degree=ex.MAX_DEGREE, folds=5)
    assert jengine.moment_counter()["calls"] == out["moment_calls"] == 1
    assert out["best_degree"] == int(sel.best_degree) == 3
    assert out["criterion"] == sel.criterion
    yty = float(np.sum(np.asarray(yh, np.float64) ** 2))
    np.testing.assert_allclose(out["scores"]["sse"],
                               np.asarray(sel.sweep.scores.sse),
                               rtol=0, atol=64 * EPS32 * yty)
    assert out["auto_degree"] == int(jcore.polyfit(x, y, "auto").degree)
    assert out["stream_degree"] == 3


# -------------------------------------------------------------- serve_fits
def test_serve_fits_against_reference():
    from repro import core as jcore
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_serve_fits as ex
    finally:
        sys.path.pop(0)
    out = run_example("serve_fits")
    assert out["served"] == out["requests"] == 100
    assert out["new_keys_after_warmup"] == 0
    assert out["novel_spec_keys"] == out["novel_specs"] == 2
    assert out["worst_gap"] < 1e-3
    worst = 0.0
    for (x, y), got in zip(ex.trace(), out["coeffs"]):
        ref = jcore.polyfit(jnp.asarray(x), jnp.asarray(y), 3).coeffs
        worst = max(worst, float(np.max(np.abs(np.asarray(got)
                                               - np.asarray(ref)))))
    assert worst < 1e-3, worst
    assert out["tight"]["fallback_used"] is True
    assert len(out["line"]) == 2


# ----------------------------------------------------------- monitors_demo
def test_monitors_demo_against_reference():
    from repro import core as jcore
    from repro.runtime import plan_reslice
    from repro.train import LossCurveMonitor, StepTimeMonitor
    out = run_example("monitors_demo")
    mon = LossCurveMonitor(degree=1, decay=0.995)
    rng = np.random.default_rng(0)
    for step in range(300):
        mon.observe(step, 6.0 * (step + 10) ** -0.15 + rng.normal(0, 0.02))
    np.testing.assert_allclose(out["slope"], mon.slope_at(300), rtol=1e-4)
    np.testing.assert_allclose(out["predict_600"], mon.predict(600),
                               rtol=1e-4)
    assert out["eta"] == mon.eta_to(4.0, 300)
    assert out["diverging"] == bool(mon.diverging(300))
    st = StepTimeMonitor(n_hosts=8, threshold=1.3)
    for step in range(25):
        t = 1.0 + rng.normal(0, 0.02, 8)
        t[3] = 1.6 + rng.normal(0, 0.05)
        st.observe(step, t)
    assert out["stragglers"] == [int(h) for h in st.stragglers(25)] == [3]
    assert out["shares"] == [float(s) for s in
                             plan_reslice(st, 25, global_batch=256).shares]
    tokens = jnp.asarray(np.logspace(7, 10, 40), jnp.float32)
    law = jcore.fit_power_law(tokens, 2.57e3 * tokens ** -0.35 + 1.69)
    got = out["power_law"]
    for key in ("scale", "exponent", "offset"):
        np.testing.assert_allclose(got[key], float(getattr(law, key)),
                                   rtol=1e-4)
    np.testing.assert_allclose(got["at_1e11"],
                               float(law(jnp.asarray(1e11))), rtol=1e-4)


# -------------------------------------------------------- fitspec_surfaces
def test_fitspec_surfaces_agree():
    from repro import api as japi
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_fitspec_surfaces as ex
    finally:
        sys.path.pop(0)
    out = run_example("fitspec_surfaces")
    assert out["ranks"] == 1
    eager = np.asarray(out["eager"])
    assert out["distributed"] == out["eager"]
    for surface in ("streaming", "serve"):
        np.testing.assert_allclose(out[surface], eager, rtol=0, atol=1e-3)
    # every robust surface recovers the planted cubic; plain LSE does not
    np.testing.assert_allclose(eager, out["true"], rtol=0, atol=5e-3)
    assert np.abs(np.asarray(out["plain"]) - out["true"]).max() > 0.1
    xs, ys, _ = ex.data()
    spec = japi.FitSpec(degree=3, method="irls",
                        irls=japi.IRLSOptions(loss="tukey"))
    ref = japi.fit(jnp.asarray(xs), jnp.asarray(ys), spec)
    np.testing.assert_allclose(eager, np.asarray(ref.coeffs), rtol=0,
                               atol=1e-4)
    assert out["iterations"] == int(ref.iterations)


@pytest.mark.parametrize("name", ["quickstart", "select_degree",
                                  "serve_fits", "monitors_demo",
                                  "fitspec_surfaces"])
def test_example_reports_launch_counts(name):
    """Every example closes with the kernels' launch counts; on the CPU
    the launchers run their plain versions, so all are 0."""
    out = run_example(name)
    assert out["device"] == "cpu"
    assert out["launches"] == {"moments_plain": 0, "moments_packed": 0,
                               "moments_packed_ring": 0, "fused_report": 0,
                               "solve_small": 0}
