"""The program's own phase spans (``repro_torch.obs.spans``), as the
per-layer readers ``metrics/fit.host_ms.batch.py``,
``fit.idle_ms.batch.py``, ``fit.solve_idle_ms.batch.py`` and
``fit.host_reads.batch.py`` read them.

The program records a span only while a profiler runs, so in a traced run
its spans cover exactly the profiled sub-window's ``counts["calls"]``
calls (a run is one process, and the readers run in it once the window
has closed).  Their stamps are µs on the trace's host clock.  A program
without the recorder gives no spans, and every reader then returns None.

``host_ms`` reads the host clock alone.  The others put device events on
the host clock first (``on_host_clock``): a trace's device timestamps do
not keep to its host clock (on the H100 machines a device event was seen
up to 50 ms before the runtime call that launched it, late in a 3 s
window), so each call's last device-to-host read is anchored to the
opening of the next call's program.
"""
from __future__ import annotations

import bisect

from pbench import devtrace

SOLVE = "fit.solve"
READ_CAT = "gpu_memcpy"
READ_NAME = "DtoH"          # a device-to-host copy: the host waits on it
# an anchor this far (µs) above both neighbours marks a pause of the
# caller, not the clocks (their step from call to call: < 0.6 ms seen)
PAUSE_US = 1000.0


def recorded() -> list:
    """The closed spans the program recorded in this process."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return []
    return [s for s in spans.recorded() if s.end_us is not None]


def union(intervals) -> list:
    """Sorted disjoint (start, end) pairs covering ``intervals``."""
    out: list[list] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys) -> float:
    """µs that two lists of sorted disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def outermost(spans) -> list:
    """(start, end) of the spans opened inside no other program span."""
    return [(s.start_us, s.end_us) for s in spans if s.parent < 0]


def named(spans, name: str) -> list:
    return [(s.start_us, s.end_us) for s in spans if s.name == name]


def is_read(event) -> bool:
    return event[1] == READ_CAT and READ_NAME in event[0]


def on_host_clock(events, spans, calls: int):
    """The device events moved onto the host clock, or None.

    The cells run one closed-loop caller whose every call ends with
    blocking reads of its answer, so every call makes as many
    device-to-host reads, the last of them ends before the caller opens
    the next call, and the card is idle in between.  The end of call k's
    last read is anchored to the start of call k+1's first outermost span;
    between anchors the offset is interpolated, beyond them held.  The
    host opens that span only after the read has returned, so a moved time
    lies late by the caller's step between the two (tens of µs), unless
    the caller paused there; such an anchor is replaced.  None
    where the reads or the outermost spans do not divide into ``calls``
    equal runs, and below two calls (no anchor)."""
    reads = sorted((e for e in events if is_read(e)), key=lambda e: e[2])
    starts = sorted(s.start_us for s in spans if s.parent < 0)
    if (calls < 2 or not reads or len(reads) % calls
            or not starts or len(starts) % calls):
        return None
    r, q = len(reads) // calls, len(starts) // calls
    at = [reads[(k + 1) * r - 1][2] + reads[(k + 1) * r - 1][3]
          for k in range(calls - 1)]
    shift = [starts[(k + 1) * q] - at[k] for k in range(calls - 1)]
    # a caller paused between a read and its next call (a collection, a
    # preemption) lifts one anchor far above both neighbours: take theirs
    for k in range(len(shift)):
        near = [shift[j] for j in (k - 1, k + 1) if 0 <= j < len(shift)]
        if near and shift[k] - max(near) > PAUSE_US:
            shift[k] = sum(near) / len(near)

    def moved(t: float) -> float:
        i = bisect.bisect_right(at, t)
        if i == 0:
            return t + shift[0]
        if i == len(at) or at[i] == at[i - 1]:
            return t + shift[i - 1]
        f = (t - at[i - 1]) / (at[i] - at[i - 1])
        return t + shift[i - 1] + f * (shift[i] - shift[i - 1])

    out = []
    for name, cat, ts, dur in events:
        a = moved(ts)
        out.append((name, cat, a, moved(ts + dur) - a))
    return out


def _calls(ctx):
    return (ctx.get("counts") or {}).get("calls")


def host_ms(ctx):
    """Host ms a call spent inside the program (its outermost spans)."""
    iv = union(outermost(recorded()))
    calls = _calls(ctx)
    if not iv or not calls:
        return None
    return sum(b - a for a, b in iv) / 1e3 / calls


def _placed(ctx):
    """(spans, device events on the host clock, calls), or None."""
    spans = recorded()
    calls = _calls(ctx)
    if not spans or not calls or not ctx.get("events"):
        return None
    events = on_host_clock(ctx["events"], spans, calls)
    return None if events is None else (spans, events, calls)


def idle_ms(ctx, name: str | None = None):
    """Ms a call in which the card ran nothing while the host was inside
    the program's outermost spans, or with ``name`` inside the spans of
    that name."""
    placed = _placed(ctx)
    if placed is None:
        return None
    spans, events, calls = placed
    iv = union(outermost(spans) if name is None else named(spans, name))
    if not iv:
        return 0.0
    busy = devtrace.merged(events, iv[0][0], iv[-1][1])
    idle = sum(b - a for a, b in iv) - overlap_us(iv, busy)
    return idle / 1e3 / calls


def host_reads(ctx):
    """Device-to-host copies a call made from inside the program: those
    whose start, on the host clock, lies inside an outermost program
    span."""
    placed = _placed(ctx)
    if placed is None:
        return None
    spans, events, calls = placed
    iv = union(outermost(spans))
    starts = sorted(e[2] for e in events if is_read(e))
    n = 0
    j = 0
    for a, b in iv:
        while j < len(starts) and starts[j] < a:
            j += 1
        while j < len(starts) and starts[j] <= b:
            n += 1
            j += 1
    return n / calls
