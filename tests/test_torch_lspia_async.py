"""Asynchronous LSPIA on the port: the async and fleet-async cases of
``tests/test_lspia_async.py`` run on ``repro_torch`` on the CPU, then the
port's ``core.distributed.async_lspia_fit`` and the fleet's sharded async
ingest against the reference's on the same data and chaos schedules.

The coordinator is a host loop on a virtual tick clock whose iterate lives
in float64; only each shard's gradient, a float32 pass over its points,
differs between the packages in its last bits.  So the two take the same
ticks, apply the same number of coefficient versions and count the same
fault events, and their coefficients agree within 1e-5 of
max(1, max|c|)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import distributed as jdist
from repro.runtime import chaos as jchaos
from repro.serve import fit_engine as jfe
from repro.serve import fleet as jfleet
from repro_torch import interop
from repro_torch.api.spec import FitSpec, LSPIAOptions
from repro_torch.core import distributed, lspia, polyfit
from repro_torch.engine.plan import NumericsPolicy
from repro_torch.runtime.chaos import ChaosSchedule, FaultEvent
from repro_torch.serve import fit_engine as fe
from repro_torch.serve.fleet import FitFleet, FleetConfig

torch.set_num_threads(1)

CPU = "cpu"
COEF_TOL = 1e-5


def _workload(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, n)).astype(np.float32)
    y = (np.sin(x) + 0.02 * rng.normal(0, 1, n)).astype(np.float32)
    return x, y


def _spec(**lspia_kw):
    # normalize=True: LSPIA needs the [-1, 1] domain map for a contractive
    # Chebyshev iteration
    return FitSpec(degree=5, basis="chebyshev", method="lspia",
                   numerics=NumericsPolicy(solver="auto", normalize=True),
                   lspia=LSPIAOptions(**lspia_kw))


def _values(poly, x):
    return poly(torch.from_numpy(x)).numpy()


def _cond_tol(af):
    cond = float(af.poly.diagnostics.condition)
    return max(50 * np.finfo(np.float32).eps * max(cond, 1.0), 1e-4)


# ------------------------------------------------------- async fixed point
def test_async_matches_sync_fixed_point():
    x, y = _workload()
    sync = lspia.lspia_fit(x, y, 5, basis="chebyshev", device=CPU)
    assert bool(sync.converged)
    af = distributed.async_lspia_fit(x, y, _spec(), n_shards=4, device=CPU)
    assert af.converged
    gap = float(np.max(np.abs(_values(af.poly, x) - _values(sync.poly, x))))
    assert gap <= _cond_tol(af), gap
    assert af.stats["updates"] == af.iterations


def test_async_converges_past_stalled_shard():
    x, y = _workload()
    sync = lspia.lspia_fit(x, y, 5, basis="chebyshev", device=CPU)
    chaos = ChaosSchedule((FaultEvent(tick=5, worker=1, kind="stall",
                                      duration=40),))
    af = distributed.async_lspia_fit(x, y, _spec(), n_shards=4, chaos=chaos,
                                     device=CPU)
    assert af.converged
    assert af.stats["updates_during_stall"] > 0
    flagged = {s for _, ss in af.stats["straggler_verdicts"] for s in ss}
    assert 1 in flagged, af.stats["straggler_verdicts"]
    shares = af.stats["reslice"]
    assert shares is not None and shares[1] < max(shares)
    gap = float(np.max(np.abs(_values(af.poly, x) - _values(sync.poly, x))))
    assert gap <= _cond_tol(af)


def test_async_rejects_stale_contributions():
    x, y = _workload(n=512)
    chaos = ChaosSchedule((FaultEvent(tick=2, worker=0, kind="delay",
                                      duration=6),
                           FaultEvent(tick=4, worker=1, kind="delay",
                                      duration=6),))
    af = distributed.async_lspia_fit(x, y, _spec(staleness=0), n_shards=2,
                                     chaos=chaos, device=CPU)
    assert af.converged
    assert af.stats["stale_rejected"] > 0


def test_async_momentum_accelerates():
    x, y = _workload()
    plain = distributed.async_lspia_fit(x, y, _spec(), n_shards=4,
                                        device=CPU)
    mom = distributed.async_lspia_fit(x, y, _spec(momentum=0.5), n_shards=4,
                                      device=CPU)
    assert plain.converged and mom.converged
    assert mom.iterations < plain.iterations


def test_async_validation():
    x, y = _workload(n=64)
    with pytest.raises(ValueError, match="method"):
        distributed.async_lspia_fit(x, y, FitSpec(degree=3), n_shards=2,
                                    device=CPU)
    with pytest.raises(ValueError, match="decay"):
        distributed.async_lspia_fit(
            x, y, dataclasses.replace(_spec(), decay=0.9), n_shards=2,
            device=CPU)
    with pytest.raises(ValueError, match="shards"):
        distributed.async_lspia_fit(x[:2], y[:2], _spec(), n_shards=4,
                                    device=CPU)


def test_async_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _workload(n=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.async_lspia_fit(x, y, _spec(), n_shards=2)


# --------------------------------------------------------- fleet surface
def _fleet_series(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, n)).astype(np.float32)
    y = (0.3 - 1.2 * x + 0.5 * x ** 3
         + 0.02 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _async_fleet(chaos=None, **fit):
    fit.setdefault("degree", 3)
    return FitFleet(FleetConfig(fit=fe.FitServeConfig(**fit), n_workers=4,
                                chunk_width=256, chaos=chaos), device=CPU)


def test_fleet_async_lspia_matches_polyfit():
    x, y = _fleet_series()
    fleet = _async_fleet()
    h = fleet.submit_async_lspia(x, y, n_shards=4)
    fleet.run(max_ticks=5000)
    assert h.done and h.failed is None and h.converged
    assert h.harvested == 4
    assert fleet.stats["async_harvests"] == 4
    assert h.updates_while_partial >= 1
    ref = polyfit(x, y, 3, device=CPU).coeffs.numpy()
    gap = float(np.max(np.abs(h.coeffs - ref)))
    assert gap < 5e-3, gap


def test_fleet_async_lspia_survives_stalled_worker():
    x, y = _fleet_series()
    clean = _async_fleet()
    hc = clean.submit_async_lspia(x, y, n_shards=4)
    clean.run(max_ticks=5000)
    chaos = ChaosSchedule((FaultEvent(tick=2, worker=0, kind="stall",
                                      duration=30),))
    fleet = _async_fleet(chaos)
    h = fleet.submit_async_lspia(x, y, n_shards=4)
    fleet.run(max_ticks=5000)
    assert h.done and h.converged
    np.testing.assert_array_equal(hc.coeffs, h.coeffs)


def test_fleet_async_lspia_validation():
    x, y = _fleet_series(n=128)
    fleet = FitFleet(FleetConfig(fit=fe.FitServeConfig(degree=5, decay=0.99),
                                 n_workers=2, chunk_width=64), device=CPU)
    with pytest.raises(ValueError, match="decay"):
        fleet.submit_async_lspia(x, y, n_shards=2)
    fleet = _async_fleet()
    with pytest.raises(ValueError, match="lspia"):
        fleet.submit_async_lspia(x, y, spec=fleet.pool_specs.fixed)
    with pytest.raises(ValueError, match="shards"):
        fleet.submit_async_lspia(x[:5], y[:5], n_shards=8)


# ------------------------------------------------- against the reference
def _jspec(**lspia_kw):
    from repro.engine.plan import NumericsPolicy as JNumerics
    return japi.FitSpec(degree=5, basis="chebyshev", method="lspia",
                        numerics=JNumerics(solver="auto", normalize=True),
                        lspia=japi.LSPIAOptions(**lspia_kw))


def _events(*events):
    return (ChaosSchedule(tuple(FaultEvent(*e) for e in events)),
            jchaos.ChaosSchedule(tuple(jchaos.FaultEvent(*e)
                                       for e in events)))


CASES = {
    "clean": (4096, 4, {}, ()),
    "momentum": (4096, 4, {"momentum": 0.5}, ()),
    "stall": (4096, 4, {}, ((5, 1, "stall", 40),)),
    "stale": (512, 2, {"staleness": 0}, ((2, 0, "delay", 6),
                                         (4, 1, "delay", 6))),
    "faults": (2048, 4, {"momentum": 0.5}, ((3, 0, "crash"),
                                            (4, 1, "poison"),
                                            (6, 2, "drop"),
                                            (2, 3, "stall", 12))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_async_lspia_against_reference(name):
    n, shards, opts, events = CASES[name]
    x, y = _workload(n=n)
    tchaos, jch = _events(*events)
    t = distributed.async_lspia_fit(x, y, _spec(**opts), n_shards=shards,
                                    chaos=tchaos, device=CPU)
    j = jdist.async_lspia_fit(jnp.asarray(x), jnp.asarray(y),
                              _jspec(**opts), n_shards=shards, chaos=jch)
    assert (t.iterations, t.ticks, t.converged) == \
        (j.iterations, j.ticks, j.converged)
    assert t.stats == j.stats
    jc = np.asarray(j.poly.coeffs, np.float64)
    tc = t.poly.coeffs.numpy().astype(np.float64)
    np.testing.assert_allclose(tc, jc,
                               atol=COEF_TOL * max(1.0, np.abs(jc).max()))
    assert t.step == pytest.approx(j.step, rel=1e-5)


def test_fleet_async_lspia_against_reference():
    x, y = _fleet_series()
    tchaos, jch = _events((2, 0, "stall", 30), (3, 2, "drop"))
    tf = _async_fleet(tchaos)
    jf = jfleet.FitFleet(jfleet.FleetConfig(
        fit=jfe.FitServeConfig(degree=3), n_workers=4, chunk_width=256,
        chaos=jch))
    th = tf.submit_async_lspia(x, y, n_shards=4)
    jh = jf.submit_async_lspia(x, y, n_shards=4)
    spec = japi.FitSpec(degree=2, method="lspia",
                        lspia=japi.LSPIAOptions(momentum=0.5))
    th2 = tf.submit_async_lspia(x, y, spec=interop.fit_spec(spec),
                                n_shards=3)
    jh2 = jf.submit_async_lspia(x, y, spec=spec, n_shards=3)
    tf.run(max_ticks=5000)
    jf.run(max_ticks=5000)
    assert tf.tick == jf.tick and tf.stats == jf.stats
    assert tf.compiled_executables() == jf.compiled_executables()
    for t, j in ((th, jh), (th2, jh2)):
        assert (t.done, t.harvested, t.updates, t.updates_while_partial,
                t.converged, t.count, t.done_tick) == \
            (j.done, j.harvested, j.updates, j.updates_while_partial,
             j.converged, j.count, j.done_tick)
        jc = np.asarray(j.coeffs, np.float64)
        np.testing.assert_allclose(t.coeffs, jc, atol=2e-3 * max(
            1.0, np.abs(jc).max()))
