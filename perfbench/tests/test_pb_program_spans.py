"""The readers of the program's phase spans (``pbench/program_spans.py``
and ``metrics/fit.*.batch.py``): known answers on synthetic spans and
device events whose clock runs off the host's, None where either is
missing, and a CPU traced run of each cell."""
from __future__ import annotations

import sys

import pytest

from pbench import cells, program_spans

from pb_small import CELLS, run

HOST, IDLE, SOLVE_IDLE, READS = ("fit.host_ms.batch", "fit.idle_ms.batch",
                                 "fit.solve_idle_ms.batch",
                                 "fit.host_reads.batch")
READERS = (HOST, IDLE, SOLVE_IDLE, READS)
DTOH = "Memcpy DtoH (Device -> Pageable)"


class S:
    """A recorded span as ``repro_torch.obs.spans.recorded()`` gives it."""

    def __init__(self, name, parent, start_us, end_us):
        self.name, self.parent = name, parent
        self.start_us, self.end_us = start_us, end_us


def device_clock(h):
    """The trace's device ts of host time ``h`` (µs): 5 ms behind, and
    running at half speed through the second call."""
    if h <= 100:
        return h - 5000
    if h < 200:
        return 0.5 * h - 4950
    return h - 5050


def on_device(name, cat, h0, h1, clock=device_clock):
    d0 = clock(h0)
    return (name, cat, d0, clock(h1) - d0)


def layout(calls=3, program_read=True, clock=device_clock, pause=None):
    """Each call k (host µs from 100 k): ``api.fit`` 0-60 holding
    ``fit.solve`` 30-55; on the card a kernel 5-25, a read 40-42 (the
    program's), a kernel 45-50, then the caller's reads 94-96 and
    98-100, the next call opening at 100, or 5 ms later after call
    ``pause``."""
    spans, events = [], []
    for k in range(calls):
        o = 100.0 * k + (5000.0 if pause is not None and k > pause else 0.0)
        spans += [S("api.fit", -1, o, o + 60),
                  S("fit.solve", len(spans), o + 30, o + 55)]
        on = [("moments_reg_kernel", "kernel", 5, 25),
              ("svd", "kernel", 45, 50),
              (DTOH, "gpu_memcpy", 94, 96), (DTOH, "gpu_memcpy", 98, 100)]
        if program_read:
            on.append((DTOH, "gpu_memcpy", 40, 42))
        events += [on_device(n, c, o + a, o + b, clock) for n, c, a, b in on]
    return spans, {"events": events, "counts": {"calls": calls}}


def _read(name, ctx):
    return cells.metric_reader(name).read(ctx)


def _use(monkeypatch, spans):
    monkeypatch.setattr(program_spans, "recorded", lambda: list(spans))


def test_known_answers_through_a_drifting_device_clock(monkeypatch):
    spans, ctx = layout()
    _use(monkeypatch, spans)
    assert _read(HOST, ctx) == pytest.approx(0.060)
    # api.fit 60 µs less the kernels (20 + 5) and the program's read (2)
    assert _read(IDLE, ctx) == pytest.approx(0.033)
    # fit.solve 25 µs less the read and the second kernel
    assert _read(SOLVE_IDLE, ctx) == pytest.approx(0.018)
    # the program's read, not the caller's two
    assert _read(READS, ctx) == pytest.approx(1.0)


def test_the_raw_device_clock_would_misplace_everything():
    spans, ctx = layout()
    moved = program_spans.on_host_clock(ctx["events"], spans, 3)
    raw_reads = [e for e in ctx["events"] if program_spans.is_read(e)]
    assert all(e[2] < 0 for e in raw_reads)
    got = sorted(round(e[2], 6) for e in moved if program_spans.is_read(e))
    assert got == sorted(100.0 * k + t for k in range(3)
                         for t in (40, 94, 98))


def test_a_paused_caller_moves_no_read(monkeypatch):
    """The caller stalls 5 ms before opening call 2: that anchor lies far
    above both neighbours and gives way to them."""
    spans, ctx = layout(calls=4, clock=lambda h: h - 5000, pause=1)
    _use(monkeypatch, spans)
    assert _read(IDLE, ctx) == pytest.approx(0.033)
    assert _read(READS, ctx) == pytest.approx(1.0)
    assert _read(SOLVE_IDLE, ctx) == pytest.approx(0.018)


def test_solve_idle_is_part_of_idle_and_idle_of_host(monkeypatch):
    spans, ctx = layout()
    _use(monkeypatch, spans)
    assert (_read(SOLVE_IDLE, ctx) <= _read(IDLE, ctx)
            <= _read(HOST, ctx))


def test_no_read_inside_the_spans_counts_zero(monkeypatch):
    spans, ctx = layout(program_read=False)
    _use(monkeypatch, spans)
    assert _read(READS, ctx) == 0.0
    assert _read(SOLVE_IDLE, ctx) == pytest.approx(0.020)


def test_overlapping_outer_spans_count_once(monkeypatch):
    _use(monkeypatch, [S("stream.update", -1, 0.0, 100.0),
                       S("stream.update", -1, 50.0, 150.0)])
    assert _read(HOST, {"counts": {"calls": 1}}) == pytest.approx(0.15)


@pytest.mark.parametrize("name", (IDLE, SOLVE_IDLE, READS))
def test_none_where_the_reads_do_not_divide_into_the_calls(monkeypatch,
                                                          name):
    spans, ctx = layout()
    _use(monkeypatch, spans)
    ctx["events"] = ctx["events"][:-1]
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", (IDLE, SOLVE_IDLE, READS))
def test_none_below_two_calls(monkeypatch, name):
    spans, ctx = layout(calls=1)
    _use(monkeypatch, spans)
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(monkeypatch, name):
    _, ctx = layout()
    _use(monkeypatch, [])
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", (IDLE, SOLVE_IDLE, READS))
def test_none_without_device_events(monkeypatch, name):
    spans, _ = layout()
    _use(monkeypatch, spans)
    assert _read(name, {"events": [], "counts": {"calls": 3}}) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_calls(monkeypatch, name):
    spans, ctx = layout()
    _use(monkeypatch, spans)
    assert _read(name, dict(ctx, counts={"calls": 0})) is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    _, ctx = layout()
    assert program_spans.recorded() == []
    for name in READERS:
        assert _read(name, ctx) is None


def test_open_spans_are_left_out(monkeypatch):
    from repro_torch.obs import spans
    monkeypatch.setattr(spans, "recorded", lambda: [
        S("api.fit", -1, 0.0, 10.0), S("api.fit", -1, 20.0, None)])
    assert [(s.start_us, s.end_us) for s in program_spans.recorded()] == [
        (0.0, 10.0)]


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_traced_run_reads_host_ms(cell):
    from repro_torch.obs import spans
    spans.clear()
    try:
        res = run(cell, trace=True)
    finally:
        spans.clear()
    got = res["metrics"]
    assert res["correct"], res["checks"]
    assert got[HOST]["value"] > 0 and got[HOST]["unit"] == "ms"
    for name in (IDLE, SOLVE_IDLE, READS):
        assert name not in got, "the CPU run has no device events"
