"""Port parity for ``repro_torch.runtime`` and ``repro_torch.train.monitors``
against ``repro.runtime`` / ``repro.train.monitors``, on the CPU.

Chaos schedules, restart backoffs and reslice plans are host arithmetic
on the same seeds: equal event for event.  The step-time and loss-curve
fits go through each package's streaming moments in float32 (two float32
orders of the same few sums through a 2×2 or 3×3 solve): the step-time
levels agree within 1e-5 relative, the loss curve's slope and prediction
within 1e-5 of the sum of their terms' magnitudes, and the detector's
verdicts, which compare the levels with a 1.4–3× margin, are equal."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import runtime as jrt
from repro.train import monitors as jmon
from repro_torch import runtime as trt
from repro_torch import train as ttrain

torch.set_num_threads(1)

CPU = "cpu"
REL = 1e-5


def _events(schedule):
    return [(e.tick, e.worker, e.kind, e.duration) for e in schedule.events]


# ------------------------------------------------------------------ chaos
@pytest.mark.parametrize("seed", [0, 1, 5, 17, 123])
def test_chaos_from_seed_matches_reference(seed):
    kw = dict(crashes=2, stalls=3, drops=2, delays=1, poisons=2,
              stall_ticks=40, delay_ticks=5)
    j = jrt.ChaosSchedule.from_seed(seed, 4, 64, **kw)
    t = trt.ChaosSchedule.from_seed(seed, 4, 64, **kw)
    assert _events(t) == _events(j)
    for w in range(4):
        assert _events(trt.ChaosSchedule(t.for_worker(w))) == \
            _events(jrt.ChaosSchedule(j.for_worker(w)))


@pytest.mark.parametrize("spec", ["crash=1,stall=1",
                                  "crash=1,stall=1,poison=1,drop=1,delay=1",
                                  "stall=3,poison=2", "crash"])
@pytest.mark.parametrize("seed", [0, 9])
def test_chaos_parse_matches_reference(spec, seed):
    j = jrt.ChaosSchedule.parse(spec, seed, 4, horizon=64)
    t = trt.ChaosSchedule.parse(spec, seed, 4, horizon=64)
    assert _events(t) == _events(j)
    with pytest.raises(ValueError, match="fault kind"):
        trt.ChaosSchedule.parse("explode=1", seed, 4)
    with pytest.raises(ValueError, match="kind"):
        trt.FaultEvent(1, 0, "melt")
    with pytest.raises(ValueError, match="tick"):
        trt.FaultEvent(-1, 0, "crash")


def test_chaos_worker_applies_faults_as_the_reference():
    """The same schedule through both wrappers around one echo worker:
    the same alive/stalled states and the same (delay, reply) pairs."""
    class _Msg:
        def __init__(self, kind, n):
            self.kind, self.n = kind, n

        def poisoned(self):
            return _Msg("poisoned", self.n)

    class _Echo:
        def process(self, msg, tick):
            return [_Msg("result" if msg.kind == "solve" else "ack", msg.n)]

        def reset(self):
            pass

    sched = [(2, "drop", 0), (3, "delay", 4), (5, "poison", 0),
             (6, "stall", 3), (11, "crash", 0)]
    jw = jrt.ChaosWorker(_Echo(), 0, tuple(jrt.FaultEvent(t, 0, k, d)
                                           for t, k, d in sched))
    tw = trt.ChaosWorker(_Echo(), 0, tuple(trt.FaultEvent(t, 0, k, d)
                                           for t, k, d in sched))
    for tick in range(1, 14):
        out = []
        for wk in (jw, tw):
            wk.begin_tick(tick)
            kind = "solve" if tick % 2 else "ingest"
            reps = wk.process(_Msg(kind, tick), tick)
            out.append((wk.alive, wk.stalled(tick),
                        [(d, r.kind, r.n) for d, r in reps]))
        assert out[0] == out[1], tick
    assert [e.kind for e in tw.faults_applied] == \
        [e.kind for e in jw.faults_applied]


# ---------------------------------------------------------- fault tolerance
def test_heartbeat_detects_dead_host():
    hb = trt.HeartbeatTracker(n_hosts=4, timeout_s=10.0)
    now = 1000.0
    for h in range(4):
        hb.beat(h, now)
    hb.beat(2, now + 100)
    assert hb.dead_hosts(now + 105) == [0, 1, 3]
    assert hb.dead_hosts(now + 5) == []


@pytest.mark.parametrize("jitter", [None, "decorrelated"])
@pytest.mark.parametrize("seed", [0, 3, 1000])
def test_restart_backoffs_match_reference(jitter, seed):
    kw = dict(max_restarts=6, base_backoff_s=4.0, max_backoff_s=32.0,
              jitter=jitter, seed=seed)
    j = jrt.RestartPolicy(**kw)
    t = trt.RestartPolicy(**kw)
    assert [t.next_backoff() for _ in range(8)] == \
        [j.next_backoff() for _ in range(8)]


@given(st.integers(0, 10_000), st.integers(1, 20))
@settings(max_examples=30, deadline=None)
def test_restart_policy_jitter_properties(seed, max_restarts):
    base, cap = 1.5, 12.0
    rp = trt.RestartPolicy(max_restarts=max_restarts, base_backoff_s=base,
                           max_backoff_s=cap, seed=seed)
    draws = [rp.next_backoff() for _ in range(max_restarts + 3)]
    good, exhausted = draws[:max_restarts], draws[max_restarts:]
    assert all(b is not None and base <= b <= cap for b in good)
    assert all(b is None for b in exhausted)


def test_restart_policy_rejects_bad_config():
    with pytest.raises(ValueError, match="jitter"):
        trt.RestartPolicy(jitter="bogus")
    with pytest.raises(ValueError, match="backoff"):
        trt.RestartPolicy(base_backoff_s=5.0, max_backoff_s=1.0)


def test_elastic_plan_matches_reference():
    for hosts, chips, mp in ((6, 4, 8), (2, 4, 4), (1, 8, 16)):
        j = jrt.ElasticPlan.plan(hosts, chips, mp, resume_step=120)
        t = trt.ElasticPlan.plan(hosts, chips, mp, resume_step=120)
        assert (t.n_hosts, t.mesh_shape, t.resume_step) == \
            (j.n_hosts, j.mesh_shape, j.resume_step)


def _gap_series(seed, n_hosts, steps, slow=None):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        t = 1.0 + rng.normal(0, 0.05, n_hosts)
        if slow is not None and s >= steps // 3:
            t[slow] = 2.5 + 0.1 * s
        out.append(t)
    return out


@pytest.mark.parametrize("seed,slow,threshold", [(0, 1, 1.4), (1, None, 1.4),
                                                 (2, 3, 3.0), (3, 0, 2.0)])
def test_failure_detector_verdicts_match_reference(seed, slow, threshold):
    j = jrt.FailureDetector(4, timeout_s=5.0, straggler_threshold=threshold)
    t = trt.FailureDetector(4, timeout_s=5.0, straggler_threshold=threshold,
                            device=CPU)
    for step, times in enumerate(_gap_series(seed, 4, 24, slow)):
        now = 100.0 + step
        j.observe_step(step, times, now=now)
        t.observe_step(step, times, now=now)
        if step == 15:      # host 2 stops beating: dead after the timeout
            j.hb.last_seen[2] = t.hb.last_seen[2] = now - 10.0
        assert t.verdict(step, now=now) == j.verdict(step, now=now), step


def test_failure_detector_flags_chaos_heartbeat_loss():
    wk = trt.ChaosWorker(_Silent(), 0, (trt.FaultEvent(5, 0, "crash"),))
    det = trt.FailureDetector(n_hosts=1, timeout_s=3.0, device=CPU)
    deaths = []
    for tick in range(1, 12):
        wk.begin_tick(tick)
        if wk.alive:
            det.hb.beat(0, float(tick))
        if det.verdict(tick, now=float(tick))["dead"]:
            deaths.append(tick)
    assert deaths == [8, 9, 10, 11]


def test_failure_detector_flags_chaos_persistent_straggler():
    wk = trt.ChaosWorker(_Silent(), 0, (trt.FaultEvent(4, 0, "stall", 100),))
    det = trt.FailureDetector(n_hosts=3, timeout_s=50.0,
                              straggler_threshold=1.5, device=CPU)
    step = 0
    for tick in range(1, 20):
        wk.begin_tick(tick)
        times = np.asarray([5.0 if wk.stalled(tick) else 1.0, 1.0, 1.0])
        det.observe_step(step, times, now=float(tick))
        step += 1
    v = det.verdict(step, now=19.0)
    assert v["stragglers"] == [0] and v["dead"] == []


class _Silent:
    def process(self, msg, tick):
        return []

    def reset(self):
        pass


# ------------------------------------------------------------ monitors
def _monitors(levels, steps=6, decay=0.5):
    j = jmon.StepTimeMonitor(len(levels), decay=decay)
    t = ttrain.StepTimeMonitor(len(levels), decay=decay, device=CPU)
    for s in range(steps):
        j.observe(s, np.asarray(levels, float))
        t.observe(s, np.asarray(levels, float))
    return j, t, steps - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_time_levels_match_reference(seed):
    j = jmon.StepTimeMonitor(5, decay=0.98, threshold=1.3)
    t = ttrain.StepTimeMonitor(5, decay=0.98, threshold=1.3, device=CPU)
    for step, times in enumerate(_gap_series(seed, 5, 30, slow=seed)):
        j.observe(step, times)
        t.observe(step, times)
        lj, lt = j.fitted_levels(step), t.fitted_levels(step)
        np.testing.assert_allclose(lt, lj, rtol=REL, atol=REL)
        assert t.stragglers(step) == j.stragglers(step)


@pytest.mark.parametrize("levels,batch,floor", [
    ([1.0, 1.0, 4.0, 1.0], 64, 2), ([1.0, 1000.0, 1000.0, 1000.0], 9, 2),
    ([1.0, 1.0, 1.0, 1.0], 8, 2), ([1.0, 2.0, 3.0, 5.0, 8.0], 101, 1)])
def test_plan_reslice_matches_reference(levels, batch, floor):
    j, t, step = _monitors(levels)
    ja = jrt.plan_reslice(j, step, global_batch=batch, min_share=floor)
    ta = trt.plan_reslice(t, step, global_batch=batch, min_share=floor)
    assert isinstance(ta, trt.ResliceAction)
    assert ta.shares == ja.shares and ta.total == batch
    with pytest.raises(ValueError, match="min_share"):
        trt.plan_reslice(t, step, global_batch=len(levels) * 3 - 1,
                         min_share=3)


def test_loss_curve_monitor_matches_reference():
    rng = np.random.default_rng(4)
    kw = dict(degree=2, decay=0.995, ridge=1e-6)
    j = jmon.LossCurveMonitor(**kw)
    t = ttrain.LossCurveMonitor(**kw, device=CPU)
    assert not t.ready and t.eta_to(0.5, 0) is None
    for step in range(0, 4000, 40):
        loss = 3.0 * np.exp(-step / 1500.0) + 0.4 + 0.01 * rng.normal()
        j.observe(step, loss)
        t.observe(step, loss)
    assert t.ready == j.ready
    # the slope and the prediction are sums of terms that cancel (slope
    # at step 3960: -1.412 + 1.553), so each is held to 1e-5 of the sum
    # of its terms' magnitudes: the two packages' Grams differ in their
    # last float32 bits and the 3×3 solve has κ ≈ 1.4e3, which leaves
    # the coefficients ~1e-5 apart, and the cancellation would scale a
    # bound relative to the value itself by up to 20×
    c = np.abs(np.asarray(j.fit().coeffs, np.float64))
    k = np.arange(3)
    for step in (2000, 3960, 6000):
        u = step / 1000.0
        slope_terms = float(np.sum(k[1:] * c[1:] * u ** (k[1:] - 1))) / 1e3
        assert abs(t.slope_at(step) - j.slope_at(step)) <= REL * slope_terms
        value_terms = float(np.sum(c * u ** k))
        assert abs(t.predict(step) - j.predict(step)) <= REL * value_terms
        assert t.diverging(step) == j.diverging(step)
    for target in (0.9, 0.6):
        assert t.eta_to(target, 3960) == j.eta_to(target, 3960)
    np.testing.assert_allclose(t.fit().coeffs.numpy(),
                               np.asarray(j.fit().coeffs),
                               atol=2 * REL * c.max())


def test_monitors_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ttrain.StepTimeMonitor(4),
                 lambda: ttrain.LossCurveMonitor(),
                 lambda: trt.FailureDetector(4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
