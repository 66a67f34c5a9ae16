"""``repro_torch.obs.spans``: phase spans inside ``api.fit`` and the
stream path, recorded only under a profiler, on the profiler trace's
clock.  CPU only: the card's ``kernels.launch`` span is not reached
here."""
from __future__ import annotations

import json
import statistics
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api, obs
from repro_torch.core import streaming
from repro_torch.obs import spans

FIT_CHILDREN = {"fit.plan", "fit.domain", "fit.moments", "fit.solve",
                "fit.report"}


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def _batch(b=16, n=512, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, n, generator=g) * 4 - 2
    c = torch.randn(b, 4, generator=g)
    y = (c[:, :1] + c[:, 1:2] * x + c[:, 2:3] * x ** 2 + c[:, 3:] * x ** 3
         + 0.1 * torch.randn(b, n, generator=g))
    return x, y


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(rec, i):
    return [s.name for s in rec if s.parent == i]


def test_spans_stay_out_of_the_public_names():
    assert "spans" not in obs.__all__


def test_no_profiler_records_nothing():
    x, y = _batch()
    api.fit(x, y, api.FitSpec(degree=3), device="cpu")
    assert spans.recorded() == []
    assert spans.dropped() == 0


def test_no_profiler_shares_one_null_context_a_name():
    assert spans.span("api.fit") is spans.span("api.fit")
    with spans.span("api.fit") as got:
        assert got is None


def test_api_fit_nests_its_phases():
    x, y = _batch()
    with _cpu_profile():
        api.fit(x, y, api.FitSpec(degree=3), device="cpu")
    rec = spans.recorded()
    assert [s.name for s in rec if s.parent == -1] == ["api.fit"]
    root = next(i for i, s in enumerate(rec) if s.name == "api.fit")
    assert sorted(_children(rec, root)) == sorted(FIT_CHILDREN)
    assert len(rec) == 1 + len(FIT_CHILDREN)
    assert "kernels.launch" not in {s.name for s in rec}
    for s in rec:
        assert s.end_us is not None and s.end_us >= s.start_us
        if s.parent >= 0:
            p = rec[s.parent]
            assert p.start_us <= s.start_us and s.end_us <= p.end_us
    kids = [s for s in rec if s.parent == root]
    order = [s.name for s in sorted(kids, key=lambda s: s.start_us)]
    assert order == ["fit.plan", "fit.domain", "fit.moments", "fit.solve",
                     "fit.report"]


def test_stream_records_state_updates_and_result():
    x, y = _batch()
    spec = api.FitSpec(degree=3)
    with _cpu_profile():
        st = spec.streaming((16,), device="cpu")
        for i in range(8):
            st = streaming.update(st, x[:, i * 64:(i + 1) * 64],
                                  y[:, i * 64:(i + 1) * 64])
        api.stream_result(st)
    rec = spans.recorded()
    outer = [s.name for s in rec if s.parent == -1]
    assert Counter(outer) == {"stream.state": 1, "stream.update": 8,
                              "stream.result": 1}
    assert outer[0] == "stream.state" and outer[-1] == "stream.result"
    for i, s in enumerate(rec):
        if s.name == "stream.state":
            assert _children(rec, i) == ["fit.plan"]
        elif s.name == "stream.update":
            assert _children(rec, i) == ["fit.plan", "fit.moments"]
        elif s.name == "stream.result":
            assert _children(rec, i) == ["fit.solve", "fit.report"]
    assert len(rec) == 1 + 1 + 8 * 3 + 3


def test_pinned_domain_update_records_its_domain_map():
    x, y = _batch()
    spec = api.FitSpec(degree=3, domain=(0.0, 0.5))
    with _cpu_profile():
        st = spec.streaming((16,), device="cpu")
        streaming.update(st, x, y)
    rec = spans.recorded()
    up = next(i for i, s in enumerate(rec) if s.name == "stream.update")
    assert _children(rec, up) == ["fit.domain", "fit.plan", "fit.moments"]


def _contaminated(b=16, n=512, seed=0):
    """``_batch`` with a fifth of the points thrown off by ±50."""
    x, y = _batch(b, n, seed)
    g = torch.Generator().manual_seed(seed + 1)
    bad = torch.rand(b, n, generator=g) < 0.2
    sign = torch.where(torch.rand(b, n, generator=g) < 0.5, -1.0, 1.0)
    return x, torch.where(bad, y + 50.0 * sign, y)


def _under(rec, i, name):
    """Whether span ``i`` lies inside a span called ``name``."""
    while i >= 0:
        if rec[i].name == name:
            return True
        i = rec[i].parent
    return False


@pytest.mark.parametrize("loss", ["tukey", "huber"])
def test_irls_fit_records_its_sweeps(loss):
    x, y = _contaminated()
    spec = api.FitSpec(degree=3, method="irls",
                       irls=api.IRLSOptions(loss=loss))
    with _cpu_profile():
        res = api.fit(x, y, spec, device="cpu")
    rec = spans.recorded()
    it = res.iterations
    assert 0 < it < spec.irls.max_iter and bool(res.converged.all())
    assert [s.name for s in rec if s.parent == -1] == ["api.fit"]
    count = Counter(s.name for s in rec)
    assert count["irls.sweep"] == it
    assert count["irls.scale"] == it + 1
    # a stop test before every sweep, and the one that ended the loop
    assert count["irls.converge"] == it + 1
    # the residuals and the ψ weights of every sweep and of the end
    assert count["irls.weights"] == 2 * (it + 1)
    assert count["fit.moments"] == it + 1
    for i, s in enumerate(rec):
        if s.name.startswith("irls."):
            assert _under(rec, i, "api.fit"), s
        if s.name == "irls.sweep":
            kids = sorted((k for k in rec if k.parent == i),
                          key=lambda k: k.start_us)
            assert [k.name for k in kids] == [
                "irls.weights", "irls.scale", "irls.weights", "fit.moments"]
        if s.name == "irls.converge":
            assert not _under(rec, i, "irls.sweep")
    converge = sorted((s.start_us for s in rec if s.name == "irls.converge"))
    sweeps = sorted((s.start_us for s in rec if s.name == "irls.sweep"))
    assert all(a < b for a, b in zip(converge, sweeps))


def test_irls_stream_update_records_its_scale():
    x, y = _contaminated()
    spec = api.FitSpec(degree=3, method="irls",
                       irls=api.IRLSOptions(loss="tukey"))
    with _cpu_profile():
        st = spec.streaming((16,), device="cpu")
        for i in range(4):
            st = streaming.update(st, x[:, i * 128:(i + 1) * 128],
                                  y[:, i * 128:(i + 1) * 128])
    rec = spans.recorded()
    scale = [i for i, s in enumerate(rec) if s.name == "irls.scale"]
    assert len(scale) == 4 * spec.irls.stream_sweeps
    assert all(_under(rec, i, "stream.update") for i in scale)

def test_stamps_sit_on_the_trace_clock(tmp_path):
    x, y = _batch()
    spec = api.FitSpec(degree=3)
    with _cpu_profile() as prof:
        for _ in range(20):
            api.fit(x, y, spec, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    rec = spans.recorded()
    names = {s.name for s in rec}
    twins: dict[str, list] = {}
    for e in trace["traceEvents"]:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in names):
            twins.setdefault(e["name"], []).append(e)
    diffs = []
    for name in names:
        mine = sorted((s for s in rec if s.name == name),
                      key=lambda s: s.start_us)
        theirs = sorted(twins[name], key=lambda e: e["ts"])
        assert len(mine) == len(theirs)
        diffs += [s.start_us - float(e["ts"]) for s, e in zip(mine, theirs)]
    assert len(diffs) == 20 * 6
    assert abs(statistics.median(diffs)) < 20.0
    assert int(trace["baseTimeNanoseconds"]) == spans.trace_base_ns(
        time.time_ns())


def test_nothing_is_recorded_after_the_profiler_stops():
    x, y = _batch()
    spec = api.FitSpec(degree=3)
    with _cpu_profile():
        api.fit(x, y, spec, device="cpu")
    n = len(spans.recorded())
    assert n == 6
    api.fit(x, y, spec, device="cpu")
    assert len(spans.recorded()) == n


def test_a_full_buffer_counts_what_it_drops():
    rec = spans.SpanRecorder(capacity=3)
    with _cpu_profile():
        for i in range(5):
            with rec.span(f"s{i}"):
                pass
    assert [s.name for s in rec.recorded()] == ["s0", "s1", "s2"]
    assert rec.dropped() == 2
    rec.clear()
    assert rec.recorded() == [] and rec.dropped() == 0


def test_spans_on_two_threads_keep_their_own_parents():
    rec = spans.SpanRecorder()
    both_open = threading.Barrier(2, timeout=30)
    inner_done = threading.Barrier(2, timeout=30)

    def worker(k):
        with rec.span(f"outer{k}"):
            both_open.wait()
            with rec.span(f"inner{k}"):
                inner_done.wait()

    with _cpu_profile():
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    got = rec.recorded()
    by_name = {s.name: (i, s) for i, s in enumerate(got)}
    assert len(got) == 4
    for k in range(2):
        oi, outer = by_name[f"outer{k}"]
        _, inner = by_name[f"inner{k}"]
        assert outer.parent == -1
        assert inner.parent == oi
        assert inner.thread == outer.thread
    assert by_name["outer0"][1].thread != by_name["outer1"][1].thread


def test_a_raising_body_still_closes_its_span():
    rec = spans.SpanRecorder()
    with _cpu_profile():
        with pytest.raises(ValueError):
            with rec.span("outer"):
                raise ValueError("boom")
        with rec.span("after"):
            pass
    got = rec.recorded()
    assert [s.name for s in got] == ["outer", "after"]
    assert got[0].end_us is not None
    assert got[1].parent == -1


def test_span_works_as_a_decorator():
    rec = spans.SpanRecorder()

    @rec.span("deco")
    def f(a, b=2):
        """doc"""
        with rec.span("inside"):
            return a + b

    assert f(1) == 3 and f.__doc__ == "doc" and f.__name__ == "f"
    assert rec.recorded() == []
    with _cpu_profile():
        assert f(1, b=5) == 6
    got = rec.recorded()
    assert [(s.name, s.parent) for s in got] == [("deco", -1),
                                                 ("inside", 0)]


def test_clear_while_open_leaves_no_stale_parent():
    rec = spans.SpanRecorder()
    with _cpu_profile():
        with rec.span("outer"):
            rec.clear()
            with rec.span("inner"):
                pass
    got = rec.recorded()
    assert [(s.name, s.parent) for s in got] == [("inner", -1)]


def test_many_threads_lose_no_span_and_no_parent():
    import sys
    rec = spans.SpanRecorder()
    n_threads, n_spans = 16, 300
    start = threading.Barrier(n_threads, timeout=30)

    def worker(k):
        start.wait()
        for i in range(n_spans):
            with rec.span(f"outer{k}"):
                with rec.span(f"inner{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = rec.recorded()
    assert len(got) == 2 * n_threads * n_spans
    for s in got:
        if s.name.startswith("inner"):
            up = got[s.parent]
            assert up.name == "outer" + s.name[len("inner"):]
            assert up.thread == s.thread
            assert up.start_us <= s.start_us <= s.end_us <= up.end_us
        else:
            assert s.parent == -1
