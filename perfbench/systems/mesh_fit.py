"""The mesh cell's system: one series too large for a card, held as
contiguous blocks on the cell's ranks, one to a card, and fitted by the
port's mesh executor as the README's distributed example calls it
(``api.FitSpec(...).distributed(make_host_mesh(data=world))`` on NCCL).

Rank r holds the r-th of ``chips`` equal parts of the traffic's x range
(the blocks of a time-ordered series): ``points_per_rank`` float32 points
drawn on its card from the seed, in chunks, into x and y allocated once.
All ranks share one planted polynomial.  Rank 0 builds the program's
kernels, draws its block and starts the peers (``pbench/ranks.py``);
every rank then warms the call, and rank 0 decides each call, and the end
of the window, by a broadcast.  Each call ends with rank 0's coefficients
and count on the host; the rate is every point of every rank fitted over
the window's seconds.  The profiler runs on rank 0 alone.

``correct``, once the peers have ended and rank 0 has freed its block:

* ``sse_excess``: every call's coefficients against the plain float64
  reference over every rank's block (``reference/lsq.py``), each block
  redrawn on rank 0 in turn and its float64 sums added;
* ``count_gap``: the largest |count - chips * points_per_rank| of the
  calls;
* ``rank_gap``: the largest difference between a rank's answer of the
  last call (coefficients, domain shift and scale) and rank 0's: the
  answer is replicated, so it is 0;
* ``draw_gap``: the largest difference between a block as its rank drew
  it and as rank 0 redrew it, at ``SAMPLES`` evenly spaced points: the
  reference is of the data that was fitted.
"""
from __future__ import annotations

import math
import time

import numpy as np

from pbench import devtrace, gen, ranks, runner
from reference import lsq

CHUNK_POINTS = 1 << 26     # points a block is drawn in at a time
SAMPLES = 4097             # points of a block compared after its redraw
PROFILE_MIN_CALLS = 10     # a profiled sub-window holds at least these
WARM_CALLS = 3


def check_traffic(tr: dict) -> None:
    """This system runs one closed-loop caller, and nothing else."""
    arr = tr["arrivals"]
    if arr.get("process") != "closed" or int(arr.get("clients", 0)) != 1:
        raise ValueError(f"mesh_fit drives one closed-loop caller, not "
                         f"{arr!r}")


def degree(ctx) -> int:
    return int(ctx.cf["spec"]["degree"])


def planted(ctx):
    """The polynomial every rank's block follows: (1, degree + 1), drawn
    from the seed's stream 0."""
    torch = ctx.torch
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, 0))
    return torch.randn(1, degree(ctx) + 1, generator=g, device=ctx.device,
                       dtype=torch.float32) * ctx.tr["coef_sd"]


def draw_block(ctx, rank: int):
    """Rank ``rank``'s block, drawn on ``ctx.device`` from the seed's
    stream (1, rank): x ~ U over the rank's part of the x range, y the
    planted polynomial plus noise (``gen.planted_series``), chunk by
    chunk into x and y allocated once, so the draw never holds more than
    a chunk besides them.  Any device of one kind gives the same bits."""
    torch = ctx.torch
    n = int(ctx.cf["points_per_rank"])
    lo, hi = ctx.tr["x"]
    part = (hi - lo) / ctx.cell.chips
    tr = {**ctx.tr, "x": [lo + rank * part, lo + (rank + 1) * part]}
    coefs = planted(ctx)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, 1, rank))
    x = torch.empty(n, dtype=torch.float32, device=ctx.device)
    y = torch.empty_like(x)
    one = torch.zeros(1, dtype=torch.long, device=ctx.device)
    for at in range(0, n, CHUNK_POINTS):
        m = min(CHUNK_POINTS, n - at)
        xc, yc = gen.planted_series(torch, g, m, coefs, one.expand(m), tr,
                                    ctx.device)
        x[at:at + m].copy_(xc)
        y[at:at + m].copy_(yc)
        del xc, yc
    return x, y


def sample(ctx, x, y) -> np.ndarray:
    """x and y at ``SAMPLES`` evenly spaced points of a block, float64."""
    torch = ctx.torch
    at = np.linspace(0, x.shape[0] - 1, SAMPLES).round().astype(np.int64)
    at = torch.as_tensor(at, device=x.device)
    return torch.cat([x[at], y[at]]).double().cpu().numpy()


def make_fit(ctx):
    """The mesh over every rank and the configuration's fit on it."""
    from repro_torch import api
    from repro_torch.launch import mesh as mesh_lib
    spec = ctx.cf["spec"]
    mesh = mesh_lib.make_host_mesh(data=ctx.cell.chips,
                                   device_type=ctx.device.type)
    fs = api.FitSpec(degree=int(spec["degree"]),
                     numerics=api.NumericsPolicy(**spec.get("numerics", {})))
    return fs.distributed(mesh)


def free_cache(ctx) -> None:
    if ctx.device.type == "cuda":
        ctx.torch.cuda.empty_cache()


def _go(ctx, on: bool) -> bool:
    """Rank 0's word, to every rank: one more call, or the window's end."""
    import torch.distributed as dist
    go = ctx.torch.tensor([float(on)], device=ctx.device)
    dist.broadcast(go, 0)
    return bool(go.item())


def answer(res) -> list[float]:
    """A call's answer as numbers: the coefficients, the domain."""
    p = res.poly
    return (p.coeffs.double().cpu().tolist()
            + [float(p.domain_shift), float(p.domain_scale)])


def exchange(ctx, last: list[float], peak: int, mine: np.ndarray):
    """Every rank's last answer, memory peak and sampled block, gathered
    on every rank: a (world, ...) float64 array."""
    import torch.distributed as dist
    torch = ctx.torch
    row = torch.as_tensor(np.concatenate([last, [float(peak)], mine]),
                          dtype=torch.float64, device=ctx.device)
    out = [torch.empty_like(row) for _ in range(ctx.cell.chips)]
    dist.all_gather(out, row)
    return torch.stack(out).cpu().numpy()


def block_sums(ctx, x, y, *, control: bool = False) -> lsq.Sums:
    """The plain reference's float64 sums of one block (with ``control``
    of its bfloat16 inputs), over rows of at most ``lsq.BLOCK_POINTS``
    points, added."""
    n = x.shape[0]
    cols = math.gcd(n, lsq.BLOCK_POINTS)
    s = lsq.row_sums(x.view(-1, cols), y.view(-1, cols), degree(ctx),
                     control=control)
    return lsq.Sums(s.s.sum(0), s.r.sum(0), s.yy.sum(0))


def add(a: lsq.Sums | None, b: lsq.Sums) -> lsq.Sums:
    return b if a is None else lsq.Sums(a.s + b.s, a.r + b.r, a.yy + b.yy)


def references(ctx, *, control: bool = False):
    """Every rank's block redrawn on this device, one at a time: the
    float64 sums over all of them, the control's (or None) and each
    block's sample."""
    total = low = None
    samples = []
    for r in range(ctx.cell.chips):
        x, y = draw_block(ctx, r)
        samples.append(sample(ctx, x, y))
        total = add(total, block_sums(ctx, x, y))
        if control:
            low = add(low, block_sums(ctx, x, y, control=True))
        del x, y
        free_cache(ctx)
    return total, low, samples


def run(ctx) -> dict:
    torch = ctx.torch
    check_traffic(ctx.tr)
    if ctx.device.type == "cuda":
        from repro_torch.kernels import build
        build.build()                 # before any peer can look for it
    x, y = draw_block(ctx, 0)
    mine = sample(ctx, x, y)
    coeffs, counts = [], []
    with ranks.start(ctx):
        fit = make_fit(ctx)
        free_cache(ctx)
        for _ in range(WARM_CALLS):
            res = fit(x, y)
        ctx.sync()
        ctx.reset_peak()
        from repro_torch import engine
        prof = ctx.profile() if ctx.trace else None
        if prof is not None:
            prof.warm()
        p_start, p_end = devtrace.sub_window(ctx.seconds)
        pcalls = 0
        collectives = {}
        clock = time.perf_counter
        t0 = window_start = clock()
        while True:
            now = clock() - t0
            if prof is not None and now < ctx.seconds:
                if not prof.running and not pcalls and now >= p_start:
                    engine.reset_collective_counter()
                    prof.start()
                elif (prof.running and now >= p_end
                      and pcalls >= PROFILE_MIN_CALLS):
                    prof.stop()
                    collectives = engine.collective_counter()
            if not _go(ctx, now < ctx.seconds):
                break
            with ctx.spans("fit"):
                res = fit(x, y)
            with ctx.spans("to_host"):
                coeffs.append(res.poly.coeffs.cpu().numpy())
                counts.append(float(res.report.count.cpu()))
            if prof is not None and prof.running:
                pcalls += 1
        elapsed = clock() - t0
        if prof is not None and prof.running:
            prof.stop()
            collectives = engine.collective_counter()
        peak = ctx.memory_peak()
        got = exchange(ctx, answer(res), peak, mine)
    del x, y, res
    free_cache(ctx)
    world, n = ctx.cell.chips, int(ctx.cf["points_per_rank"])
    deg = degree(ctx)
    shift, scale = got[0, deg + 1], got[0, deg + 2]
    sums, _, samples = references(ctx)
    c_ref = lsq.solve(sums, 0.0)
    sse_ref = lsq.sse(sums, c_ref)
    calls = len(coeffs)
    sse_excess = count_gap = float("nan")      # no call, nothing correct
    if calls:
        c = lsq.rebase(np.unique(np.stack(coeffs), axis=0), shift, scale,
                       0.0, 1.0)
        sse_excess = float(lsq.excess(
            sums, c_ref, sse_ref,
            torch.as_tensor(c, device=ctx.device)).max().item())
        count_gap = float(np.abs(np.array(counts) - world * n).max())
    answers, peaks = got[:, :deg + 3], got[:, deg + 3]
    drawn = got[:, deg + 4:]
    info = {"calls": calls, "window_s": elapsed,
            "ms_per_call": elapsed / max(calls, 1) * 1e3,
            "domain": (float(shift), float(scale)),
            "collectives_per_call": (collectives.get("calls", 0)
                                     / max(pcalls, 1)),
            "collective_bytes_per_call": (collectives.get("bytes", 0)
                                          / max(pcalls, 1)),
            "disk_written_bytes": runner.disk_written_bytes(),
            "memory_peak_bytes": [int(p) for p in peaks]}
    out = {"window_start": window_start, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak,
           "e2e": {"batch_gpts_per_s": calls * world * n / elapsed / 1e9},
           "checks": {
               "sse_excess": sse_excess, "count_gap": count_gap,
               "rank_gap": float(np.abs(answers - answers[0]).max()),
               "draw_gap": float(np.abs(drawn - np.stack(samples)).max())},
           "info": info}
    if prof is not None:
        prof.read()
        out["layer"] = {"events": prof.events, "busy_s": prof.busy_s(),
                        "window_s": prof.window_s,
                        "counts": {"calls": pcalls, "points": pcalls * n,
                                   "collectives": collectives.get("calls"),
                                   "collective_bytes":
                                       collectives.get("bytes")}}
        out["breakdown"] = prof.breakdown()
    return out


def peer(ctx) -> None:
    x, y = draw_block(ctx, ctx.rank)
    mine = sample(ctx, x, y)
    fit = make_fit(ctx)
    free_cache(ctx)
    for _ in range(WARM_CALLS):
        res = fit(x, y)
    ctx.sync()
    ctx.reset_peak()
    while _go(ctx, False):
        res = fit(x, y)
    exchange(ctx, answer(res), ctx.memory_peak(), mine)


def control(ctx) -> dict:
    """The reference one precision below (bfloat16 inputs and stored
    sums, a float32 solve), in the program's place, over every rank's
    block: on this rank alone, with no peers."""
    torch = ctx.torch
    sums, low, _ = references(ctx, control=True)
    c_ref = lsq.solve(sums, 0.0)
    sse_ref = lsq.sse(sums, c_ref)
    low = low.rounded(torch.bfloat16).to(torch.float32)
    ex = lsq.excess(sums, c_ref, sse_ref, lsq.solve(low, 0.0))
    n = ctx.cell.chips * int(ctx.cf["points_per_rank"])
    return {"sse_excess": float(ex.max().item()),
            "count_gap": float((low.count.double() - n).abs().max().item())}
