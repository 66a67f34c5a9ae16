"""A toy system on four ranks, for the contract test
(``tests/test_pb_contract.py``), which copies it with its
``BENCHMARK.json`` entries into a copy of the benchmark: no cell of the
benchmark itself runs it.

Each rank holds a block of ``points`` points of its own, drawn from the
seed; a call fits one straight line through the points of every rank,
from the ranks' sums (n, Σx, Σy, Σx², Σxy) in float32, all-reduced.
Rank 0 decides each call, and the end of the window, by a broadcast.

``correct``: every call's line against the plain float64 fit over every
rank's points, redrawn on rank 0 once the peers have ended.
"""
from __future__ import annotations

import time

from pbench import gen, ranks


def block(ctx, rank: int):
    torch = ctx.torch
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.torch_seed(ctx.seed, 1, rank))
    n = ctx.cf["points"]
    x = torch.rand(n, generator=g, device=ctx.device)
    y = 1.0 + 2.0 * x + ctx.tr["noise_sd"] * torch.randn(
        n, generator=g, device=ctx.device)
    return x, y


def sums(torch, x, y, dtype):
    x, y = x.to(dtype), y.to(dtype)
    return torch.stack([torch.ones_like(x).sum(), x.sum(), y.sum(),
                        (x * x).sum(), (x * y).sum()])


def line(s) -> tuple[float, float]:
    n, sx, sy, sxx, sxy = s.double().tolist()
    slope = (n * sxy - sx * sy) / (n * sxx - sx * sx)
    return (sy - slope * sx) / n, slope


def fit_once(ctx, x, y):
    import torch.distributed as dist
    s = sums(ctx.torch, x, y, ctx.torch.float32)
    t = time.perf_counter()
    dist.all_reduce(s)
    return line(s), time.perf_counter() - t


def _go(ctx, on: bool) -> bool:
    import torch.distributed as dist
    go = ctx.torch.tensor([float(on)], device=ctx.device)
    dist.broadcast(go, 0)
    return bool(go.item())


def reference(ctx, dtype) -> tuple[float, float]:
    torch = ctx.torch
    return line(sum(sums(torch, *block(ctx, r), dtype)
                    for r in range(ctx.cell.chips)))


def run(ctx) -> dict:
    x, y = block(ctx, 0)
    lines, reduce_s = [], 0.0
    with ranks.start(ctx):
        fit_once(ctx, x, y)
        ctx.sync()
        ctx.reset_peak()
        clock = time.perf_counter
        t0 = window_start = clock()
        while _go(ctx, clock() - t0 < ctx.seconds):
            c, r = fit_once(ctx, x, y)
            lines.append(c)
            reduce_s += r
        elapsed = clock() - t0
        peak = ctx.memory_peak()
    ref = reference(ctx, ctx.torch.float64)
    gap = max((abs(a - b) for c in lines for a, b in zip(c, ref)),
              default=float("nan"))
    calls, world = len(lines), ctx.cell.chips
    out = {"window_start": window_start, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak,
           "e2e": {"batch_gpts_per_s":
                   calls * world * ctx.cf["points"] / elapsed / 1e9},
           "checks": {"line_gap": gap}, "info": {"calls": calls}}
    if ctx.trace:
        out["layer"] = {"events": [], "busy_s": 0.0, "window_s": elapsed,
                        "counts": {"calls": calls, "allreduce_s": reduce_s}}
    return out


def peer(ctx) -> None:
    x, y = block(ctx, ctx.rank)
    fit_once(ctx, x, y)
    while _go(ctx, False):
        fit_once(ctx, x, y)


def control(ctx) -> dict:
    """The reference's sums in bfloat16, in the program's place."""
    ref = reference(ctx, ctx.torch.float64)
    low = reference(ctx, ctx.torch.bfloat16)
    return {"line_gap": max(abs(a - b) for a, b in zip(low, ref))}
