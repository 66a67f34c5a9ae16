"""Driver of the robust-fit cells: a batch of contaminated series resident
on the card, fitted back to back by one caller with
``repro_torch.api.fit(x, y, FitSpec(method="irls", ...))``.

Set-up draws the (B, n) batch on the card from the seed (x uniform, each
series its own planted polynomial plus Gaussian noise, as the batch
cells draw it), then throws a share of the points off by ±magnitude
(the traffic's ``outliers``, drawn on the card from the seed's stream 1),
and warms the call.  The window makes that call until ``--seconds`` have
passed, each call ending with its coefficients and its ``converged``
flags on the host; the rate is every point fitted over all the time of
the window, whatever the sweeps a call takes.

``correct``: every call's coefficients against the plain float64 IRLS
reference of each series (``reference/irls.py``), as the relative excess
weighted SSE at the reference's final weights; and no series left
unconverged.
"""
from __future__ import annotations

import time

from pbench import devtrace, gen, runner
from reference import irls, lsq

# a call takes ≈ 0.5 s, so the 3 s sub-window holds ≈ 6 calls; a
# profiled sub-window runs past its 3 s until it holds this many (the
# batch cells' 10 would stretch it to ≈ 5 s and its trace with it), and
# the span readers anchor the device clock on at least two
PROFILE_MIN_CALLS = 4
WARM_CALLS = 3


def make_batch(ctx):
    """The batch cells' planted batch, then the outliers: each point
    independently with probability ``share``, moved by ``magnitude``
    with a random sign."""
    torch = ctx.torch
    x, y = gen.planted_batch(torch, ctx.cf["batch"], ctx.cf["points"],
                             ctx.cf["spec"]["degree"], ctx.tr, ctx.seed,
                             ctx.device)
    out = ctx.tr["outliers"]
    if out["sign"] != "random":
        raise ValueError(f"outlier sign {out['sign']!r}: only 'random'")
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, 1))
    bad = torch.rand(y.shape, generator=g, device=ctx.device,
                     dtype=torch.float32) < out["share"]
    up = torch.rand(y.shape, generator=g, device=ctx.device,
                    dtype=torch.float32) < 0.5
    jump = torch.where(up, out["magnitude"], -out["magnitude"])
    y.add_(torch.where(bad, jump, torch.zeros_like(jump)))
    return x, y


def make_spec(ctx):
    from repro_torch import api
    sp = ctx.cf["spec"]
    return api.FitSpec(degree=sp["degree"], method=sp["method"],
                       irls=api.IRLSOptions(**sp["irls"]))


def fit_once(ctx, api, x, y, spec):
    """One call: ``api.fit`` over the whole batch, then its coefficients
    and ``converged`` flags on the host."""
    with ctx.spans("fit"):
        res = api.fit(x, y, spec, device=ctx.device)
    with ctx.spans("to_host"):
        c = res.poly.coeffs.cpu().numpy()
        conv = res.converged.cpu().numpy()
    return res, c, conv


def check_traffic(tr: dict) -> None:
    """This driver runs one closed-loop caller, and nothing else."""
    arr = tr["arrivals"]
    if arr.get("process") != "closed" or int(arr.get("clients", 0)) != 1:
        raise ValueError(f"robust_fit drives one closed-loop caller, not "
                         f"{arr!r}")


def reference(x, y, spec, control: bool = False):
    return irls.fit(x, y, spec.degree, spec.irls.loss, c=spec.irls.c,
                    control=control)


def run(ctx) -> dict:
    from repro_torch import api, engine
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
    coeffs, conv, sweeps = [], [], []
    prof = ctx.profile() if ctx.trace else None
    if prof is not None:
        prof.warm()
    p_start, p_end = devtrace.sub_window(ctx.seconds)
    pcalls = psweeps = passes = 0
    passes_at = 0
    clock = time.perf_counter
    t0 = window_start = clock()
    while True:
        now = clock() - t0
        # a traced run's window closes only once it has profiled a call
        # (a small run on a loaded host can pass its sub-window in a call)
        if now >= ctx.seconds and (prof is None or pcalls):
            break
        if prof is not None:
            if not prof.running and not pcalls and now >= p_start:
                passes_at = engine.moment_counter()["weighted"]
                prof.start()
            elif (prof.running and now >= p_end
                  and pcalls >= PROFILE_MIN_CALLS):
                prof.stop()
                passes = engine.moment_counter()["weighted"] - passes_at
        res, c, cv = fit_once(ctx, api, x, y, spec)
        coeffs.append(c)
        conv.append(cv)
        sweeps.append(int(res.iterations))
        if prof is not None and prof.running:
            pcalls += 1
            psweeps += int(res.iterations)
        del res
    elapsed = clock() - t0
    if prof is not None and prof.running:
        prof.stop()
        passes = engine.moment_counter()["weighted"] - passes_at
    peak = ctx.memory_peak()
    b, n = x.shape
    calls = len(coeffs)
    ref = reference(x, y, spec)
    # each call's largest excess, stacked so that a NaN reaches the
    # runner's finiteness check (Python's max() would drop it)
    worst = ctx.torch.stack([
        irls.excess(ref, ctx.torch.as_tensor(
            lsq.rebase(c, shift, scale, 0.0, 1.0), device=ctx.device)).max()
        for c in coeffs]).max()
    worst = float(worst.item())
    unconverged = float(max(int((~cv).sum()) for cv in conv))
    info = {"calls": calls, "window_s": elapsed,
            "ms_per_call": elapsed / max(calls, 1) * 1e3,
            "sweeps_per_call": sorted(set(sweeps)),
            "reference_sweeps_max": int(ref.sweeps.max().item()),
            "reference_unconverged": int((~ref.converged).sum().item()),
            "domain": (shift, scale),
            "disk_written_bytes": runner.disk_written_bytes(),
            "memory_peak_bytes": peak}
    out = {"window_start": window_start, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak,
           "e2e": {"batch_gpts_per_s": calls * b * n / elapsed / 1e9},
           "checks": {"sse_excess": worst, "unconverged": unconverged},
           "info": info}
    if prof is not None:
        prof.read()
        out["layer"] = {"events": prof.events, "busy_s": prof.busy_s(),
                        "window_s": prof.window_s,
                        # points: those the moment passes read, B·n
                        # each weighted pass (sweeps + 1 a call)
                        "counts": {"calls": pcalls,
                                   "points": passes * b * n,
                                   "sweeps": psweeps}}
        out["breakdown"] = prof.breakdown()
    return out


def control(ctx) -> dict:
    """The reference one precision below, in the program's place, over
    every series of the batch."""
    x, y = make_batch(ctx)
    spec = make_spec(ctx)
    ref = reference(x, y, spec)
    ctl = reference(x, y, spec, control=True)
    return {"sse_excess": float(irls.excess(ref, ctl.coeffs).max().item())}
