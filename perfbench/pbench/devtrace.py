"""The device trace of a run's profiled sub-window, and what is read from
it: the device events, the benchmark's own host spans, the busy share,
the device operations that took most time and the longest idle gaps.

The trace is read from kineto's chrome-trace export, never through
``key_averages()`` (which builds the profiler's Python event tree and
took minutes for 10⁵ events).  Copied with changes from ``chip_smoke.py``
(``_trace_device_us``, ``_fleet_busy``, commit 7ff5df5): device time is
the union of the intervals of kernels, copies and sets, so overlapping
streams are not counted twice, and the window is the benchmark's own
``pb.window`` span.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pb."
WINDOW_SPAN = "pb.window"
TOP = 10
PROFILE_AT = 0.4          # a traced run profiles from 40% of its window
PROFILE_SECONDS = 3.0     # for about this long: a short, steady sub-window


def sub_window(seconds: float) -> tuple[float, float]:
    """Start and end, in seconds from the window's start, of the profiled
    sub-window of a traced run of ``seconds``."""
    start = PROFILE_AT * seconds
    return start, start + min(PROFILE_SECONDS, 0.3 * seconds)


class Spans:
    """The benchmark's host spans around its calls into each layer:
    ``torch.profiler.record_function`` while a profiled sub-window is on,
    nothing at all otherwise (a span costs a few µs on every call of the
    window)."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)


class Profile:
    """A profiled sub-window: ``start()`` profiles (CPU and, on a card,
    CUDA activity) after a synchronize, ``stop()`` synchronizes and stops,
    and ``read()``, called once the measured window has closed, parses the
    trace into ``events`` / ``spans_list`` and the window ``t0`` / ``t1``
    (µs, the trace's clock)."""

    def __init__(self, torch, device, spans: Spans):
        self.torch, self.device, self.spans = torch, device, spans
        self.running = False

    def warm(self) -> None:
        """Profile one tiny operation, in set-up: the first profiled
        region of a process initializes the tracer (seconds on a card),
        which must not fall inside the measured window."""
        self.start()
        self.torch.ones(1, device=self.device).add_(1)
        self.stop()
        del self._prof

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.spans.on = True
        self._win = torch.profiler.record_function(WINDOW_SPAN)
        self._win.__enter__()
        self.running = True

    def stop(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self._win.__exit__(None, None, None)
        self.spans.on = False
        self._prof.__exit__(None, None, None)
        self.running = False

    def read(self) -> "Profile":
        self.events, self.spans_list, self.t0, self.t1 = \
            read_profile(self._prof)
        del self._prof
        return self

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        return busy_s(self.events, self.t0, self.t1)

    def breakdown(self) -> dict:
        return breakdown(self.events, self.spans_list, self.t0, self.t1)


def read_profile(prof):
    """(device events, host spans, window start, window end) of a finished
    profiler run; events and spans are (name, cat, ts_us, dur_us)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    events, spans = [], []
    t0 = t1 = None
    for e in raw:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        rec = (str(e.get("name", "")), cat, float(e.get("ts", 0.0)),
               float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            events.append(rec)
        elif cat == "user_annotation" and rec[0].startswith(SPAN_PREFIX):
            if rec[0] == WINDOW_SPAN:
                t0, t1 = rec[2], rec[2] + rec[3]
            else:
                spans.append(rec)
    if t0 is None:
        raise RuntimeError("the profiled window's span is missing from the "
                           "trace")
    return events, spans, t0, t1


def merged(events, t0: float, t1: float) -> list:
    """The union of the events' intervals, clipped to [t0, t1], as sorted
    disjoint (start, end) pairs in µs."""
    iv = sorted((max(ts, t0), min(ts + dur, t1))
                for _, _, ts, dur in events)
    out = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(events, t0: float, t1: float) -> float:
    """Seconds in [t0, t1] in which some kernel, copy or set ran."""
    return sum(b - a for a, b in merged(events, t0, t1)) / 1e6


def matching(events, patterns) -> list:
    """The events whose name contains any of ``patterns``."""
    return [e for e in events if any(p in e[0] for p in patterns)]


def total_s(events) -> float:
    return sum(e[3] for e in events) / 1e6


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``void moments_reg_kernel<...>(...)`` →
    ``moments_reg_kernel``)."""
    name = re.sub(r"^void\s+", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and out:
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out) or name)[:120]


def _span_at(spans, t: float) -> str:
    best = None
    for name, _, ts, dur in spans:
        if ts <= t <= ts + dur and (best is None or dur < best[1]):
            best = (name, dur)
    return best[0] if best else "host.outside_spans"


def breakdown(events, spans, t0: float, t1: float) -> dict:
    """The device operations that took most time, summed by short name,
    and the longest idle gaps of the window, each named by the innermost
    benchmark span the host was in at the gap's middle."""
    by_name: dict[str, float] = {}
    for name, _, _, dur in events:
        k = short_name(name)
        by_name[k] = by_name.get(k, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = merged(events, t0, t1)
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_span_at(spans, (a + b) / 2), (b - a) / 1e6]
            for a, b in gaps[:TOP]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
