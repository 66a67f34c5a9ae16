"""Wall-clock phase spans on the profiler's clock.

Run any call of the port under ``torch.profiler`` and its phases
(``api.fit``, ``fit.plan``, ``fit.moments``, ``fit.solve``, ...) appear in
the profiler's trace beside the kernels they launched, and in
``recorded()``:

* ``span(name)`` is a context manager, and a decorator.  With no profiler
  on it returns a shared no-op context after one check of the profiler's
  process-wide flag (ns; an unconditional ``record_function`` costs µs).
  With a profiler on it opens ``torch.profiler.record_function(name)`` and
  appends one record (name, parent, start, end, thread) to a bounded
  process-wide buffer; a body that raises still closes its span.
* ``recorded()`` returns those records with their stamps in the profiler
  trace's own µs, so they line up with the device events of an exported
  Chrome trace; ``clear()`` empties the buffer; ``dropped()`` counts the
  spans refused once it was full.

Parents are kept per thread (fleet workers launch from threads).  The
flag is the process's, so a worker thread's spans are recorded too; the
profiler's trace holds their twins only where it traces that thread (a
CPU profiler traces the thread that started it).  Unlike
``obs.trace.Tracer``, a request log on the fleet's tick clock, these spans
nest and carry wall time.  There is no exporter: the profiler's own trace
holds each span's ``record_function`` twin.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 20
# the exported trace's ts is (unix ns - baseTimeNanoseconds) / 1000, and
# Kineto rounds that base down to a whole multiple of this many seconds
# (torch/profiler/_cupti_monitor_trace.py, _default_base_ns: "matching
# Kineto"); tests/test_torch_spans.py holds the rule to an exported trace
TRACE_BASE_SECONDS = 7_889_238

# set while any torch profiler runs, in every thread (the thread-local
# torch.autograd._profiler_enabled() is false in threads it does not trace)
_profiler = torch.autograd.profiler


class Span(NamedTuple):
    """One recorded span; ``parent`` is the index in ``recorded()`` of the
    span it opened in on its thread, -1 for an outermost one; ``end_us`` is
    None while it is open."""

    name: str
    parent: int
    start_us: float
    end_us: float | None
    thread: int


def trace_base_ns(unix_ns: int) -> int:
    """The base of a profiler trace taken at ``unix_ns``."""
    period = TRACE_BASE_SECONDS * 1_000_000_000
    return unix_ns // period * period


def _wrap(recorder: "SpanRecorder", name: str, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Open(recorder, name):
            return fn(*args, **kwargs)
    return inner


class _Null:
    """The no-op span of one name, shared by every call."""

    __slots__ = ("recorder", "name")

    def __init__(self, recorder, name):
        self.recorder, self.name = recorder, name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.recorder, self.name, fn)


class _Open(_Null):
    """A span while a profiler is on."""

    __slots__ = ("_rf", "_rec")

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._rec = self.recorder._open(self.name)
        return None

    def __exit__(self, *exc):
        self.recorder._close(self._rec)
        self._rf.__exit__(*exc)
        return False


class SpanRecorder:
    """A bounded buffer of spans; the module's functions use one shared
    by the process.

    A record holds its parent's record, so ``recorded()`` finds the
    parent's index even after ``clear()`` (then -1).  The hot path takes
    no lock: ``list.append`` is atomic under the interpreter lock, and a
    ``threading.Lock`` cost tens of µs a span on the card's host."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self._buf: list[list] = []  # [name, up, start_ns, end_ns, tid]
        self._dropped = 0
        self._lock = threading.Lock()   # for the count of dropped spans
        self._local = threading.local()
        self._nulls: dict[str, _Null] = {}

    def span(self, name: str):
        if not _profiler._is_profiler_enabled:
            null = self._nulls.get(name)
            if null is None:
                null = self._nulls.setdefault(name, _Null(self, name))
            return null
        return _Open(self, name)

    def _open(self, name: str) -> list:
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            # once a thread: a system call, costly where those are trapped
            local.tid = threading.get_native_id()
        rec = [name, stack[-1] if stack else None, time.time_ns(), None,
               local.tid]
        if len(self._buf) < self.capacity:
            self._buf.append(rec)
        else:
            with self._lock:
                self._dropped += 1
        stack.append(rec)
        return rec

    def _close(self, rec: list) -> None:
        rec[3] = time.time_ns()
        self._local.stack.pop()

    def recorded(self) -> list[Span]:
        """A snapshot of the buffer, stamps in the profiler trace's µs."""
        raw = list(self._buf)
        if not raw:
            return []
        index = {id(r): i for i, r in enumerate(raw)}
        base = trace_base_ns(raw[0][2])
        return [Span(name, -1 if up is None else index.get(id(up), -1),
                     (t0 - base) / 1e3,
                     None if t1 is None else (t1 - base) / 1e3, tid)
                for name, up, t0, t1, tid in raw]

    def clear(self) -> None:
        self._buf.clear()
        with self._lock:
            self._dropped = 0

    def dropped(self) -> int:
        return self._dropped


RECORDER = SpanRecorder()
span = RECORDER.span
recorded = RECORDER.recorded
clear = RECORDER.clear
dropped = RECORDER.dropped
