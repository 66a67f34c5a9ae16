"""Driver of the batched-fit cells: a batch of series resident on the
card, fitted back to back by one caller, either by ``repro_torch.api.fit``
or, where the configuration gives ``chunk_points``, through a stream state
fed the batch's column blocks (``streaming.update``, ``api.stream_result``).

Set-up draws the (B, n) batch on the card from the seed (x uniform, each
series its own planted polynomial plus Gaussian noise) and warms the call.
The window makes that call until ``--seconds`` have passed, each call
ending with its coefficients on the host; the rate is every point fitted
over all the time of the window.

``correct``: every call's coefficients and counts against the plain
float64 reference of each series (``reference/lsq.py``).
"""
from __future__ import annotations

import time

import numpy as np

from pbench import devtrace, gen, runner
from reference import lsq

PROFILE_MIN_CALLS = 10     # a profiled sub-window holds at least these
WARM_CALLS = 3


def make_batch(ctx):
    return gen.planted_batch(ctx.torch, ctx.cf["batch"], ctx.cf["points"],
                             ctx.cf["spec"]["degree"], ctx.tr, ctx.seed,
                             ctx.device)


def make_spec(ctx):
    from repro_torch import api
    return api.FitSpec(degree=ctx.cf["spec"]["degree"])


def fit_once(ctx, api, x, y, spec):
    """One call as the configuration makes it: ``api.fit`` over the whole
    batch, or with ``chunk_points`` a stream state fed the batch's column
    blocks by ``streaming.update`` and read by ``api.stream_result``."""
    from repro_torch.core import streaming
    spans = ctx.spans
    chunk = ctx.cf.get("chunk_points")
    with spans("fit"):
        if chunk:
            st = spec.streaming(x.shape[:-1], device=ctx.device)
            for lo in range(0, x.shape[-1], chunk):
                st = streaming.update(st, x[:, lo:lo + chunk],
                                      y[:, lo:lo + chunk])
            res = api.stream_result(st)
        else:
            res = api.fit(x, y, spec, device=ctx.device)
    with spans("to_host"):
        c = res.poly.coeffs.cpu().numpy()
        cnt = res.report.count.cpu().numpy()
    return res, c, cnt


def check_traffic(tr: dict) -> None:
    """This driver runs one closed-loop caller, and nothing else."""
    arr = tr["arrivals"]
    if arr.get("process") != "closed" or int(arr.get("clients", 0)) != 1:
        raise ValueError(f"batch_fit drives one closed-loop caller, not "
                         f"{arr!r}")


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch import api
    check_traffic(ctx.tr)
    x, y = make_batch(ctx)
    spec = make_spec(ctx)
    for _ in range(WARM_CALLS):
        res, _, _ = fit_once(ctx, api, x, y, spec)
    shift = float(res.poly.domain_shift)
    scale = float(res.poly.domain_scale)
    del res
    ctx.sync()
    ctx.reset_peak()
    coeffs, counts = [], []
    prof = ctx.profile() if ctx.trace else None
    if prof is not None:
        prof.warm()
    p_start, p_end = devtrace.sub_window(ctx.seconds)
    pcalls = 0
    clock = time.perf_counter
    t0 = window_start = clock()
    while True:
        now = clock() - t0
        if now >= ctx.seconds:
            break
        if prof is not None:
            if not prof.running and not pcalls and now >= p_start:
                prof.start()
            elif (prof.running and now >= p_end
                  and pcalls >= PROFILE_MIN_CALLS):
                prof.stop()
        _, c, cnt = fit_once(ctx, api, x, y, spec)
        coeffs.append(c)
        counts.append(cnt)
        if prof is not None and prof.running:
            pcalls += 1
    elapsed = clock() - t0
    if prof is not None and prof.running:
        prof.stop()
    peak = ctx.memory_peak()
    b, n = x.shape
    calls = len(coeffs)
    # the reference: float64 sums of every series, in the program's domain
    # only where that is the identity (a degree-3 float32 fit does not map)
    sums = lsq.row_sums(x, y, spec.degree)
    c_ref = lsq.solve(sums, 0.0)
    sse_ref = lsq.sse(sums, c_ref)
    worst = 0.0
    for c in coeffs:
        cc = lsq.rebase(c, shift, scale, 0.0, 1.0)
        ex = lsq.excess(sums, c_ref, sse_ref,
                        torch.as_tensor(cc, device=ctx.device))
        worst = max(worst, float(ex.max().item()))
    count_gap = float(np.abs(np.stack(counts) - n).max())
    info = {"calls": calls, "window_s": elapsed,
            "ms_per_call": elapsed / max(calls, 1) * 1e3,
            "domain": (shift, scale),
            "disk_written_bytes": runner.disk_written_bytes(),
            "memory_peak_bytes": peak}
    out = {"window_start": window_start, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak,
           "e2e": {"batch_gpts_per_s": calls * b * n / elapsed / 1e9},
           "checks": {"sse_excess": worst, "count_gap": count_gap},
           "info": info}
    if prof is not None:
        prof.read()
        out["layer"] = {"events": prof.events, "busy_s": prof.busy_s(),
                        "window_s": prof.window_s,
                        "counts": {"calls": pcalls,
                                   "points": pcalls * b * n}}
        out["breakdown"] = prof.breakdown()
    return out


def control(ctx) -> dict:
    """The reference one precision below, in the program's place, over
    every series of the batch."""
    torch = ctx.torch
    x, y = make_batch(ctx)
    deg = ctx.cf["spec"]["degree"]
    sums = lsq.row_sums(x, y, deg)
    c_ref = lsq.solve(sums, 0.0)
    sse_ref = lsq.sse(sums, c_ref)
    ctl = lsq.row_sums(x, y, deg, control=True)
    ctl = ctl.rounded(torch.bfloat16).to(torch.float32)
    ex = lsq.excess(sums, c_ref, sse_ref, lsq.solve(ctl, 0.0))
    return {"sse_excess": float(ex.max().item()),
            "count_gap": float((ctl.count.double() - x.shape[1])
                               .abs().max().item())}
