"""The fault-tolerant fit fleet on the port: every case of
``tests/test_fleet.py`` run on ``repro_torch.serve.fleet`` on the CPU, then
the port's fleet against the reference fleet on the same series and chaos
schedules.

The dispatcher is a host loop on a virtual tick clock, so on the same
traffic both fleets take the same ticks, count the same events, route
each request to the same workers and write a byte-identical trace.
Coefficients carry the moment path's tolerance, 2e-3 of max(1, max|c|)
(``COEF_TOL`` of ``tests/test_torch_fit_serve.py``: two float32 orders of
the same sums through a solve of κ ≲ 10⁴)."""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.launch import serve as jlaunch
from repro.runtime import chaos as jchaos
from repro.serve import fit_engine as jfe
from repro.serve import fleet as jfleet
from repro_torch import api, interop
from repro_torch.core import polyfit, streaming
from repro_torch.engine import plan as plan_lib
from repro_torch.launch import serve as tlaunch
from repro_torch.runtime.chaos import ChaosSchedule, ChaosWorker, FaultEvent
from repro_torch.serve import fit_engine as fe
from repro_torch.serve import fleet as tfleet
from repro_torch.serve.fleet import (Ack, FitFleet, FleetConfig, FleetWorker,
                                     Ingest, Solve)

torch.set_num_threads(1)

CPU = "cpu"
CHUNK = 128
COEF_TOL = 2e-3


def _series(seed, n_lo=300, n_hi=900, k=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(n_lo, n_hi))
        x = np.sort(rng.uniform(-1, 1, n)).astype(np.float32)
        y = (0.3 - 1.2 * x + 0.5 * x ** 3
             + 0.02 * rng.normal(size=n)).astype(np.float32)
        out.append((x, y))
    return out


def _fleet(chaos=None, **kw):
    kw.setdefault("fit", fe.FitServeConfig(degree=5))
    kw.setdefault("n_workers", 4)
    kw.setdefault("chunk_width", CHUNK)
    return FitFleet(FleetConfig(chaos=chaos, **kw), device=CPU)


def _run(series, chaos=None, **kw):
    fleet = _fleet(chaos, **kw)
    reqs = [fleet.submit(x, y, spec=api.FitSpec(degree=3))
            for x, y in series]
    reqs.append(fleet.submit(*series[0], degree="auto"))
    fleet.run(max_ticks=5000)
    return fleet, reqs


# ------------------------------------------------------------------ parity
def test_fleet_matches_polyfit_without_chaos():
    series = _series(0)
    fleet, reqs = _run(series)
    assert fleet.stats["completed"] == len(reqs)
    assert fleet.stats["failed"] == fleet.stats["shed"] == 0
    for r, (x, y) in zip(reqs, series):
        assert r.done and r.failed is None
        assert r.count == len(x)
        ref = polyfit(x, y, 3, device=CPU).coeffs.numpy()
        np.testing.assert_allclose(r.coeffs, ref, rtol=2e-3, atol=2e-3)
    auto = reqs[-1]
    assert auto.done and auto.degree is not None and auto.scores


def test_chaos_parity_crash_straggler_poison():
    series = _series(7, n_lo=600, n_hi=1600, k=8)
    base_fleet, base = _run(series, straggler_threshold=2.0)
    chaos = ChaosSchedule((
        FaultEvent(3, 1, "crash"),        # dies mid-ingest
        FaultEvent(2, 2, "stall", 400),   # persistent straggler
        FaultEvent(1, 3, "poison"),       # NaN-poisoned result
    ))
    fleet, reqs = _run(series, chaos, straggler_threshold=2.0)
    kinds = {e.kind for w in fleet.workers for e in w.faults_applied}
    assert kinds == {"crash", "stall", "poison"}
    assert fleet.stats["worker_deaths"] == 1
    assert fleet.stats["poisoned"] == 1
    assert fleet.stats["completed"] == len(reqs)     # zero lost
    assert fleet.stats["failed"] == 0
    assert fleet.stats["replays"] >= 1 and fleet.stats["hedges"] >= 1
    for b, c in zip(base, reqs):
        assert c.done and c.failed is None
        assert c.count == b.count                    # no double-count
        np.testing.assert_array_equal(c.coeffs, b.coeffs)
    assert reqs[-1].degree == base[-1].degree


def test_chaos_parity_drop_and_delay():
    series = _series(11, k=5)
    _, base = _run(series)
    chaos = ChaosSchedule((
        FaultEvent(2, 0, "drop"),
        FaultEvent(3, 1, "drop"),
        FaultEvent(2, 2, "delay", 10),
    ))
    fleet, reqs = _run(series, chaos)
    assert fleet.stats["completed"] == len(reqs)
    assert fleet.stats["resends"] >= 1
    for b, c in zip(base, reqs):
        assert c.count == b.count
        np.testing.assert_array_equal(c.coeffs, b.coeffs)


def test_seeded_schedule_reproduces():
    s1 = ChaosSchedule.from_seed(5, 4, 64, crashes=1, stalls=2, poisons=1)
    s2 = ChaosSchedule.from_seed(5, 4, 64, crashes=1, stalls=2, poisons=1)
    assert s1 == s2
    assert ChaosSchedule.parse("crash=1,stall=2,poison=1", 5, 4) == s1
    with pytest.raises(ValueError, match="fault kind"):
        ChaosSchedule.parse("explode=1", 0, 4)


# --------------------------------------------------- journal / idempotence
def _worker(degree=3, device=CPU):
    specs = fe.derive_pool_specs(fe.FitServeConfig(degree=degree))
    return specs, FleetWorker(0, specs, torch.float32,
                              fe.make_spec_solve(degree),
                              fe.make_spec_sweep(degree), device=device)


def test_worker_duplicate_ingest_is_idempotent():
    specs, wk = _worker()
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    y = (x ** 2).astype(np.float32)
    w = np.ones(64, np.float32)
    msg = Ingest(key=9, seq=1, x=x, y=y, w=w, spec=specs.fixed)
    [ack1] = wk.process(msg, tick=1)
    assert isinstance(ack1, Ack) and ack1.seq == 1
    snap1 = wk.states[9].snapshot()
    [ack_dup] = wk.process(msg, tick=2)          # duplicate delivery
    assert ack_dup.seq == 1                      # re-acked, not re-applied
    snap2 = wk.states[9].snapshot()
    np.testing.assert_array_equal(snap1["gram"], snap2["gram"])
    np.testing.assert_array_equal(snap1["count"], snap2["count"])
    [ack_gap] = wk.process(dataclasses.replace(msg, seq=5), tick=3)
    assert ack_gap.seq == 1                      # out-of-window: resync ack
    [res] = wk.process(Solve(key=9, spec=specs.fixed), tick=4)
    assert float(res.fixed[3]) == 64.0           # count: exactly one copy
    assert all(isinstance(a, np.ndarray) for a in res.fixed)


def test_stream_state_snapshot_restore_roundtrip():
    spec = api.FitSpec(degree=4, method="irls")
    st = streaming.StreamState.create(4, (), spec=spec, device=CPU)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, 200).astype(np.float32))
    y = x ** 2 - x
    st = streaming.update(st, x, y)
    back = streaming.StreamState.restore(st.snapshot(), spec=spec,
                                         device=CPU)
    assert torch.equal(back.moments.gram, st.moments.gram)
    assert torch.equal(back.moments.vty, st.moments.vty)
    assert back.spec == spec
    a = streaming.update(st, x, y)
    b = streaming.update(back, x, y)
    assert torch.equal(a.moments.gram, b.moments.gram)


# ----------------------------------------------------- degradation / limits
def test_overload_degrades_then_sheds():
    x = np.linspace(-1, 1, 300, dtype=np.float32)
    y = (x ** 2 - x).astype(np.float32)
    fleet = _fleet(fit=fe.FitServeConfig(degree=4), n_workers=2,
                   max_queue=6, degrade_watermark=3, max_inflight=1)
    reqs = [fleet.submit(x, y, degree="auto") for _ in range(10)]
    degraded = [r for r in reqs if r.degraded]
    shed = [r for r in reqs if r.shed]
    assert degraded and shed
    assert all(r.done and r.failed == "shed" for r in shed)
    fleet.run()
    for r in degraded:
        assert r.degraded == "degree_search->fixed"
        assert r.done and r.scores is None       # served as a fixed fit
        assert r.degree == 4
    served = [r for r in reqs if not r.shed]
    assert fleet.stats["completed"] == len(served)
    assert fleet.stats["shed"] == len(shed)
    assert fleet.stats["degraded"] == len(degraded)


def test_deadline_fails_unservable_request():
    x = np.linspace(-1, 1, 500, dtype=np.float32)
    chaos = ChaosSchedule(tuple(
        FaultEvent(1, w, "stall", 500) for w in range(2)))
    fleet = _fleet(chaos, n_workers=2)
    req = fleet.submit(x, x.copy(), service=api.ServicePolicy(deadline=10))
    for _ in range(30):
        fleet.step()
    assert req.done and req.failed == "deadline"
    assert fleet.stats["failed"] == 1
    assert fleet.pending == 0


def test_service_policy_validation():
    with pytest.raises(ValueError, match="max_retries"):
        api.ServicePolicy(max_retries=-1)
    with pytest.raises(ValueError, match="deadline"):
        api.ServicePolicy(deadline=0)


@pytest.mark.parametrize("fields", [
    {}, {"max_retries": 0, "retry_timeout": 1, "hedge": False,
         "deadline": 1}, {"max_retries": 9, "deadline": None},
    {"max_retries": -1}, {"retry_timeout": 0}, {"deadline": 0},
    {"deadline": -3}])
def test_service_policy_against_reference(fields):
    """The same fields are accepted or refused with the same message, and
    ``interop.service_policy`` carries an accepted one across."""
    try:
        ref = japi.ServicePolicy(**fields)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            api.ServicePolicy(**fields)
        assert str(got.value) == str(e)
        return
    port = api.ServicePolicy(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert interop.service_policy(ref) == port


# ------------------------------------------------------- recovery policies
def test_crashed_worker_revives_and_serves_again():
    series = _series(13, k=6)
    chaos = ChaosSchedule((FaultEvent(2, 0, "crash"),))
    fleet, reqs = _run(series, chaos, n_workers=2)
    assert fleet.stats["worker_deaths"] == 1
    assert fleet.stats["revivals"] == 1
    assert fleet.stats["completed"] == len(reqs)
    assert fleet.workers[0].alive
    r = fleet.submit(*series[0], spec=api.FitSpec(degree=3))
    fleet.run()
    assert r.done and r.failed is None


def test_hedge_rescues_straggler_pinned_request():
    series = _series(17, k=3)
    chaos = ChaosSchedule((FaultEvent(2, 0, "stall", 300),))
    fleet, reqs = _run(series, chaos, straggler_threshold=2.0)
    assert fleet.stats["hedges"] >= 1
    hedged = [r for r in reqs if r.hedged]
    assert hedged
    for r in hedged:
        assert r.done and r.failed is None
        assert len(r.workers) >= 2               # served by the backup


def test_hedging_disabled_by_service_policy():
    x = np.linspace(-1, 1, 700, dtype=np.float32)
    y = (x ** 3).astype(np.float32)
    chaos = ChaosSchedule((FaultEvent(2, 0, "stall", 60),))
    fleet = _fleet(chaos, n_workers=2, straggler_threshold=2.0)
    svc = api.ServicePolicy(hedge=False, retry_timeout=100, max_retries=50)
    req = fleet.submit(x, y, service=svc)
    fleet.run(max_ticks=5000)
    assert req.done and not req.hedged
    assert fleet.stats["hedges"] == 0


def test_poisoned_result_quarantines_worker():
    x = np.linspace(-1, 1, 400, dtype=np.float32)
    y = (1.0 + x).astype(np.float32)
    chaos = ChaosSchedule((FaultEvent(1, 0, "poison"),))
    fleet = _fleet(chaos, n_workers=2)
    req = fleet.submit(x, y)
    fleet.run()
    assert fleet.stats["poisoned"] == 1
    assert req.done and req.failed is None
    assert np.all(np.isfinite(req.coeffs))       # NaN never reached caller
    assert req.retries >= 1
    assert fleet._quarantined_until[0] > 0


# ----------------------------------------------------------- infrastructure
def test_parallel_pump_matches_serial():
    x = np.linspace(-1, 1, 500, dtype=np.float32)
    y = (x ** 2 - 0.5 * x).astype(np.float32)

    def coeffs(par):
        fleet = _fleet(n_workers=3, parallel_pump=par)
        rs = [fleet.submit(x, y) for _ in range(6)]
        fleet.run()
        fleet.close()
        return np.stack([r.coeffs for r in rs])

    np.testing.assert_array_equal(coeffs(False), coeffs(True))


def test_parallel_pump_counts_every_moment_pass():
    """Eight pump threads with a short switch interval: the moment-pass
    counter, read-modify-written by every ingest, loses no update (the
    serial run's count, which is at least one pass per chunk: hedged
    copies ingest again), and the coefficients equal the serial run's bit
    for bit."""
    series = _series(29, n_lo=700, n_hi=1500, k=12)

    def run(par):
        fleet = _fleet(n_workers=8, parallel_pump=par, chunk_width=64)
        reqs = [fleet.submit(x, y) for x, y in series]
        plan_lib.reset_moment_counter()
        fleet.run(max_ticks=5000)
        fleet.close()
        return reqs, plan_lib.moment_counter()

    serial, want = run(False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        parallel, got = run(True)
    finally:
        sys.setswitchinterval(old)
    chunks = sum(-(-len(x) // 64) for x, _ in series)
    assert got == want and want["calls"] >= chunks
    for a, b in zip(serial, parallel):
        np.testing.assert_array_equal(a.coeffs, b.coeffs)


def test_fleet_compiles_once_for_default_specs():
    fleet = _fleet()
    n0 = fleet.warmup()
    series = _series(23, k=5)
    for x, y in series:
        fleet.submit(x, y)
        fleet.submit(x, y, degree="auto")
    fleet.run()
    assert fleet.compiled_executables() == n0
    assert fleet.stats["completed"] == 2 * len(series) + 2


def test_fleet_config_validation():
    with pytest.raises(ValueError, match="n_workers"):
        FleetConfig(n_workers=0)
    with pytest.raises(ValueError, match="degrade_watermark"):
        FleetConfig(max_queue=4, degrade_watermark=9)


def test_chaos_worker_passthrough_without_events():
    class _Echo:
        def process(self, msg, tick):
            return [msg]

        def reset(self):
            pass

    wk = ChaosWorker(_Echo(), 0, ())
    wk.begin_tick(1)
    assert wk.alive and not wk.stalled(1)
    msg = Ingest(key=1, seq=1, x=None, y=None, w=None, spec=None)
    assert wk.process(msg, 1) == [(0, msg)]


def test_fleet_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FitFleet()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _worker(device=None)


# ------------------------------------------------- against the reference
def _jchaos(schedule):
    if schedule is None:
        return None
    return jchaos.ChaosSchedule(tuple(
        jchaos.FaultEvent(e.tick, e.worker, e.kind, e.duration)
        for e in schedule.events))


SCHEDULES = {
    "none": None,
    "crash_stall_poison": ChaosSchedule((
        FaultEvent(3, 1, "crash"), FaultEvent(2, 2, "stall", 400),
        FaultEvent(1, 3, "poison"))),
    "drop_delay": ChaosSchedule((
        FaultEvent(2, 0, "drop"), FaultEvent(3, 1, "drop"),
        FaultEvent(2, 2, "delay", 10))),
    "seeded_all_kinds": ChaosSchedule.parse(
        "crash=1,stall=1,poison=1,drop=1,delay=1", 0, 4, horizon=16),
}


def _both(schedule, series, specs, tmp_path, **kw):
    """The same traffic through the reference fleet and the port's."""
    cfg = dict(n_workers=4, chunk_width=CHUNK, straggler_threshold=2.0,
               trace=True, **kw)
    jf = jfleet.FitFleet(jfleet.FleetConfig(
        fit=jfe.FitServeConfig(degree=5), chaos=_jchaos(schedule), **cfg))
    tf = FitFleet(FleetConfig(fit=fe.FitServeConfig(degree=5),
                              chaos=schedule, **cfg), device=CPU)
    out = []
    for fleet, port in ((jf, False), (tf, True)):
        reqs = []
        for (x, y), spec in zip(series, specs):
            if spec == "auto":
                reqs.append(fleet.submit(x, y, degree="auto"))
            elif spec is None:
                reqs.append(fleet.submit(x, y))
            else:
                reqs.append(fleet.submit(
                    x, y, spec=interop.fit_spec(spec) if port else spec))
        fleet.run(max_ticks=5000)
        path = tmp_path / f"{'port' if port else 'ref'}.jsonl"
        fleet.tracer.export_jsonl(str(path))
        out.append((fleet, reqs, path.read_bytes()))
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fleet_against_reference(name, tmp_path):
    series = _series(7, n_lo=600, n_hi=1600, k=8)
    series += series[:2]
    jspecs = ([japi.FitSpec(degree=3)] * 4
              + [None, japi.FitSpec(degree=2, ridge=1e-6),
                 japi.FitSpec(degree=5, method="lspia"),
                 japi.FitSpec(degree=4, method="lspia",
                              lspia=japi.LSPIAOptions(momentum=0.5)),
                 "auto", "auto"])
    (jf, jreqs, jtrace), (tf, treqs, ttrace) = _both(
        SCHEDULES[name], series, jspecs, tmp_path)
    assert tf.tick == jf.tick
    assert tf.stats == jf.stats
    assert tf.fits_done == jf.fits_done
    assert tf.points_ingested == jf.points_ingested
    assert tf.compiled_executables() == jf.compiled_executables()
    assert ttrace == jtrace and len(ttrace) > 0
    assert tf.latency_quantiles() == jf.latency_quantiles()
    for j, t in zip(jreqs, treqs):
        assert (t.latency_ticks, t.workers, t.replays, t.retries,
                t.hedged, t.count, t.degree, t.failed) == \
            (j.latency_ticks, j.workers, j.replays, j.retries, j.hedged,
             j.count, j.degree, j.failed), j.uid
        scale = max(1.0, float(np.abs(j.coeffs).max()))
        np.testing.assert_allclose(t.coeffs, np.asarray(j.coeffs),
                                   atol=COEF_TOL * scale, err_msg=j.uid)


def test_fleet_warmup_counts_match_reference():
    jf = jfleet.FitFleet(jfleet.FleetConfig(
        fit=jfe.FitServeConfig(degree=5), chunk_width=CHUNK))
    tf = _fleet()
    assert tf.warmup() == jf.warmup()
    x, y = _series(3, k=1)[0]
    for fleet, spec in ((jf, japi.FitSpec(degree=2)),
                        (tf, api.FitSpec(degree=2))):
        fleet.submit(x, y, spec=spec)
        fleet.run()
    assert tf.compiled_executables() == jf.compiled_executables()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_journal_snapshot_crosses_packages(direction):
    """A journal snapshot taken by one package's worker mid-series restores
    into the other's, which finishes the series to the coefficients the
    first would have given."""
    x, y = _series(5, n_lo=900, n_hi=901, k=1)[0]
    w = np.ones_like(x)
    chunks = [(x[i:i + CHUNK], y[i:i + CHUNK], w[i:i + CHUNK])
              for i in range(0, len(x), CHUNK)]
    jspecs = jfe.derive_pool_specs(jfe.FitServeConfig(degree=5))
    ref = (jfleet, jfleet.FleetWorker(0, jspecs, jnp.float32,
                                      jfe.make_spec_solve(5),
                                      jfe.make_spec_sweep(5)),
           japi.FitSpec(degree=3))
    port = (tfleet, _worker(degree=5)[1], interop.fit_spec(ref[2]))
    first, second = ((ref, port) if direction == "ref_to_port"
                     else (port, ref))
    half = len(chunks) // 2

    def ingest(side, seq):
        mod, wk, spec = side
        [ack] = wk.process(mod.Ingest(1, seq, *chunks[seq - 1], spec), seq)
        return ack

    for seq in range(1, half + 1):
        ack = ingest(first, seq)
    mod, wk, spec = second
    [rack] = wk.process(mod.Restore(1, half, ack.snapshot, spec), half + 1)
    assert rack.seq == half
    for seq in range(half + 1, len(chunks) + 1):
        ingest(second, seq)
        ingest(first, seq)
    [got] = wk.process(mod.Solve(1, spec), 99)
    [want] = first[1].process(first[0].Solve(1, first[2]), 99)
    assert float(got.fixed[3]) == float(want.fixed[3]) == len(x)
    scale = max(1.0, float(np.abs(np.asarray(want.fixed[0])).max()))
    np.testing.assert_allclose(np.asarray(got.fixed[0]),
                               np.asarray(want.fixed[0]),
                               atol=COEF_TOL * scale)


def test_launch_serve_fleet_prints_the_reference_summary(capsys):
    argv = ["--workload", "fleet", "--requests", "12", "--max-n", "900",
            "--chaos", "crash=1,stall=1,poison=1", "--assert-parity"]
    jlaunch.main(argv)
    ref = capsys.readouterr().out.splitlines()
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref) == 4
    # the same fits, ticks and latency quantiles; the recovery counters
    # and the parity line verbatim
    assert got[0].split(": ")[1].split(" in ")[0] == \
        ref[0].split(": ")[1].split(" in ")[0]
    assert got[0].split(" over ")[1] == ref[0].split(" over ")[1]
    assert got[1].split(" over ")[1] == ref[1].split(" over ")[1]
    assert got[2:] == ref[2:]


def test_launch_serve_fleet_obs_writes_valid_artifacts(tmp_path, capsys):
    argv = ["--workload", "fleet", "--requests", "16", "--max-n", "3000",
            "--obs", "--obs-dir", str(tmp_path), "--obs-every", "2",
            "--device", "cpu"]
    assert tlaunch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[obs] trace OK" in out and "[obs] tick" in out
    assert (tmp_path / "fleet_trace.jsonl").stat().st_size > 0
    assert (tmp_path / "fleet_metrics.prom").read_text().count("completed")
