"""Port parity for observability: ``repro_torch.obs`` against
``repro.obs`` on the same recorded values, on the CPU.

``metrics`` and ``trace`` are framework-free copies, so their snapshots,
Prometheus text and JSONL exports are identical byte for byte.  The SLO
monitors fit a decayed degree-1 stream of (tick, value) in float32 on each
side: fitted levels and slopes agree to 1e-4 relative, breach forecasts
(whole ticks from a scan of the fitted line) exactly."""
import json

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs as tobs

CPU = "cpu"


def test_public_names_match_the_reference():
    assert tobs.__all__ == jobs.__all__
    assert tobs.trace.TERMINAL == jobs.trace.TERMINAL
    assert tobs.FLEET_UID == jobs.FLEET_UID


def _record(obs_lib, seed):
    reg = obs_lib.MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("submitted").inc(7)
    reg.counter("completed").inc(5)
    g = reg.gauge("queue_depth")
    for v in (3, 9, 4):
        g.set(v)
    h = reg.histogram("latency_ticks")
    for v in rng.exponential(20.0, 500):
        h.observe(float(v))
    h.observe(0.0)
    other = obs_lib.HistogramSketch("latency_ticks")
    for v in rng.lognormal(2.0, 1.0, 300):
        other.observe(float(v))
    h.merge(other)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_snapshot_and_prometheus_identical(seed):
    jreg = _record(jobs, seed)
    treg = _record(tobs, seed)
    assert treg.snapshot() == jreg.snapshot()
    assert json.dumps(treg.snapshot(), sort_keys=True) \
        == json.dumps(jreg.snapshot(), sort_keys=True)
    assert treg.render_prometheus() == jreg.render_prometheus()
    for q in (0.5, 0.9, 0.99):
        assert treg.histogram("latency_ticks").quantile(q) \
            == jreg.histogram("latency_ticks").quantile(q)
    hsnap = jreg.histogram("latency_ticks").snapshot()
    back = tobs.HistogramSketch.from_snapshot("latency_ticks", hsnap)
    assert back.snapshot() == hsnap
    assert treg.snapshot_json() == jreg.snapshot_json()
    assert tobs.NULL_REGISTRY.snapshot() == jobs.NULL_REGISTRY.snapshot()


def _trace(obs_lib):
    tr = obs_lib.Tracer()
    for uid in range(3):
        tr.instant(uid, "submit", 0, n=10 * uid, auto=bool(uid % 2))
        tr.instant(uid, "admit", uid, bucket=64, slot=uid)
        tr.begin(uid, "serve", uid)
        tr.begin(uid, "serve", uid)          # idempotent
    for uid in range(2):
        tr.end(uid, "serve", 5 + uid)
        tr.instant(uid, "respond", 5 + uid, steps=5)
    tr.instant(obs_lib.FLEET_UID, "worker_death", 4, worker=1)
    return tr


def test_trace_exports_identical_and_validation_agrees(tmp_path):
    jtr, ttr = _trace(jobs), _trace(tobs)
    jtr.export_jsonl(str(tmp_path / "ref.jsonl"))
    ttr.export_jsonl(str(tmp_path / "port.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()
    jtr.export_chrome(str(tmp_path / "ref.json"))
    ttr.export_chrome(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()
    # uid 2 was admitted and never answered: both validators say so
    problems = tobs.validate_events(ttr.events)
    assert problems and problems == jobs.validate_events(jtr.events)
    with pytest.raises(AssertionError, match="uid 2"):
        tobs.assert_valid(ttr.events)
    text = (tmp_path / "ref.jsonl").read_text()
    assert tobs.parse_jsonl(text) == jobs.parse_jsonl(text)
    assert tobs.NULL_TRACER.events == [] and not tobs.NULL_TRACER.enabled


def _ramp(mon):
    tick = 0
    for tick in range(8, 8 * 16 + 1, 8):          # 10 + 0.5·tick
        mon.observe(tick, 10.0 + 0.5 * tick)
    return tick


def test_slo_monitor_forecasts_agree():
    jmon = jobs.SLOMonitor(metric="latency_ticks:p99", threshold=100.0,
                           decay=0.995)
    tmon = tobs.SLOMonitor(metric="latency_ticks:p99", threshold=100.0,
                           decay=0.995, device=CPU)
    tick = _ramp(jmon)
    assert _ramp(tmon) == tick
    assert tmon.ready == jmon.ready
    assert tmon.breach_eta(tick) == jmon.breach_eta(tick) is not None
    for t in (tick, tick + 40):
        assert tmon.level(t) == pytest.approx(jmon.level(t), rel=1e-4)
        assert tmon.slope(t) == pytest.approx(jmon.slope(t), rel=1e-4)
    trep, jrep = tmon.report(tick), jmon.report(tick)
    assert trep.keys() == jrep.keys()
    for k in ("metric", "threshold", "value", "breach_eta_ticks",
              "breached", "observations"):
        assert trep[k] == jrep[k], k
    # a flat metric never breaches on either side
    flat = [tobs.SLOMonitor(metric="q", threshold=50.0, decay=0.99,
                            device=CPU),
            jobs.SLOMonitor(metric="q", threshold=50.0, decay=0.99)]
    for mon in flat:
        for t in range(8, 200, 8):
            mon.observe(t, 5.0 + (t % 16 == 0))
        assert mon.breach_eta(192) is None


def test_slo_board_on_live_registry_agrees():
    boards = []
    for obs_lib, kw in ((jobs, {}), (tobs, {"device": CPU})):
        reg = obs_lib.MetricsRegistry()
        board = obs_lib.SLOBoard(reg, **kw)
        board.watch("latency_ticks:p99", threshold=100.0, decay=0.995)
        board.watch("queue_depth", threshold=64.0)
        rng = np.random.default_rng(0)
        tick = 0
        for step in range(24):
            tick = 8 * (step + 1)
            for v in 5.0 + 0.4 * tick + rng.exponential(2.0, 16):
                reg.histogram("latency_ticks").observe(float(v))
            reg.gauge("queue_depth").set(3)
            board.update(tick)
        boards.append((board, tick))
    (jb, tick), (tb, _) = boards
    jrep, trep = jb.report(tick), tb.report(tick)
    assert sorted(trep) == sorted(jrep)
    for ref in jrep:
        assert trep[ref]["breach_eta_ticks"] == jrep[ref]["breach_eta_ticks"]
        assert trep[ref]["value"] == jrep[ref]["value"]
    within = jrep["latency_ticks:p99"]["breach_eta_ticks"] + 1
    assert tb.breaching(tick, within) == jb.breaching(tick, within) \
        == ["latency_ticks:p99"]
    reg = tobs.MetricsRegistry()
    reg.counter("completed").inc(4)
    assert tobs.resolve_metric(reg, "completed") == 4
    reg.histogram("latency_ticks").observe(10.0)
    with pytest.raises(ValueError, match="stat"):
        tobs.resolve_metric(reg, "latency_ticks:median")


def test_observability_bundles():
    on = tobs.Observability.on(device=CPU)
    assert on.enabled and on.tracer.enabled
    assert isinstance(on.slo, tobs.SLOBoard) and on.slo.device == CPU
    assert tobs.Observability.off() is tobs.NULL_OBS
    assert not tobs.NULL_OBS.enabled
    assert tobs.NULL_OBS.slo.watch("x", 1.0) is None
    assert not tobs.Observability.on(trace=False,
                                     device=CPU).tracer.enabled
