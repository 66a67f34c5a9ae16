"""Fit-serving entry point: continuous batching over fixed slot pools on the
card (port of ``repro.launch.serve --workload fits``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``--workload fleet`` and ``--workload tokens`` are not ported yet: they
exit non-zero naming their ROADMAP.md items.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

NOT_PORTED = {
    "fleet": "the fault-tolerant fleet (serve/fleet.py) is ROADMAP.md "
             "Queue 1 item 11",
    "tokens": "the token-decode engine (serve/engine.py) is ROADMAP.md "
              "Queue 1 item 15",
}


def serve_fits(args) -> None:
    import torch

    from repro_torch import obs as obs_lib
    from repro_torch.serve import FitServeConfig, FitServeEngine

    cfg = FitServeConfig(degree=args.degree, n_slots=args.slots,
                         buckets=tuple(args.buckets), ridge=1e-9,
                         engine=args.engine)
    obs = (obs_lib.Observability.on(device=args.device) if args.obs
           else obs_lib.NULL_OBS)
    engine = FitServeEngine(cfg, obs=obs, device=args.device)

    rng = np.random.default_rng(7)
    coef = rng.normal(0, 1, args.degree + 1)

    def make_request():
        # ragged lengths, log-uniform: most requests short, a heavy tail
        n = int(np.exp(rng.uniform(np.log(args.min_n), np.log(args.max_n))))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (np.polyval(coef[::-1], x)
             + rng.normal(0, 0.1, n)).astype(np.float32)
        return engine.submit(x, y)

    execs = engine.warmup()   # runs every bucket's steps + the solves once

    reqs = [make_request() for _ in range(args.requests)]
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    recompiles = engine.compiled_executables() - execs
    done = sum(r.done for r in reqs)
    pts = sum(r.n for r in reqs)
    print(f"[serve-fits] {done}/{len(reqs)} fits, {pts} points in {dt:.2f}s "
          f"({done / dt:.1f} fits/s, {pts / dt / 1e6:.2f} Mpts/s, "
          f"{execs} executables, {recompiles} recompiles after warmup)")
    for r in reqs[:3]:
        print(f"  req {r.uid}: n={r.n} R={r.r:.4f} sse={r.sse:.3g} "
              f"coeffs={np.round(r.coeffs, 3)}")
    if done != len(reqs):
        raise RuntimeError(f"{len(reqs) - done} requests not served")
    if recompiles:
        raise RuntimeError(f"{recompiles} new executables after warmup")
    if args.obs:
        snap = obs.metrics.snapshot()
        lat = obs.metrics.histogram("fit_latency_steps")
        print(f"[serve-fits] obs: submitted="
              f"{snap['counters']['submitted']} completed="
              f"{snap['counters']['completed']} latency p50/p99 = "
              f"{lat.quantile(0.5):.0f}/{lat.quantile(0.99):.0f} steps")
        print(obs.metrics.render_prometheus(), end="")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("fits", "fleet", "tokens"),
                    default="fits")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--buckets", type=int, nargs="+", default=[256, 2048])
    ap.add_argument("--min-n", type=int, default=16)
    ap.add_argument("--max-n", type=int, default=8192)
    ap.add_argument("--engine", default="auto",
                    help="engine.plan_fit path: auto/reference/kernel/...")
    ap.add_argument("--obs", action="store_true",
                    help="metrics + trace spans: counters, latency "
                         "sketch, Prometheus exposition")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    args = ap.parse_args(argv)
    if args.workload != "fits":
        print(f"--workload {args.workload} is not ported yet: "
              f"{NOT_PORTED[args.workload]}", file=sys.stderr)
        return 2
    serve_fits(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
