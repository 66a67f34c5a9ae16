"""What the per-layer metric readers under ``metrics/`` share.

A reader gets the layer context of a traced run: ``events`` (the device
events of the profiled sub-window), ``busy_s`` and ``window_s``,
``counts`` (what the benchmark and the program counted over that
sub-window), ``host`` (host-clock figures) and ``device_kind``.  It
returns a number, or ``None`` where it finds nothing to read (the harness
then leaves the metric out); never 0 for a share of a roofline.  Each
reader names the kernels it reads by the names the profiler prints.
"""
from __future__ import annotations

from pbench import devtrace, roofline


def device_ms_per(ctx: dict, patterns, count: str):
    """Device ms of the events matching ``patterns`` per
    ``counts[count]``."""
    ev = devtrace.matching(ctx.get("events") or [], patterns)
    n = (ctx.get("counts") or {}).get(count)
    if not ev or not n:
        return None
    return devtrace.total_s(ev) * 1e3 / n


def moments_roofline(ctx: dict, patterns):
    """Percent of the HBM roofline of the moments kernels (``patterns``):
    the bytes the sub-window's points need (``counts["points"]``) over the
    kernels' summed device time."""
    ev = devtrace.matching(ctx.get("events") or [], patterns)
    points = (ctx.get("counts") or {}).get("points")
    if not ev or not points:
        return None
    return roofline.share_pct(roofline.moment_bytes(points),
                              devtrace.total_s(ev), ctx["device_kind"])


def idle_pct(ctx: dict):
    """Percent of the profiled window with no kernel, copy or set on the
    card."""
    busy, win = ctx.get("busy_s"), ctx.get("window_s")
    if not ctx.get("events") or not win or busy is None:
        return None
    return 100.0 * (1.0 - busy / win)
