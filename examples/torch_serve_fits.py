"""Continuous-batching fit serving on the PyTorch port: ragged curve-fit
requests, one ingest step per length bucket, zero new step keys across
request churn (the counterpart of ``examples/serve_fits.py``).

    PYTHONPATH=src python examples/torch_serve_fits.py           # CUDA
    PYTHONPATH=src python examples/torch_serve_fits.py --device cpu

``compiled_executables()`` counts the distinct (step, argument signature)
keys the server's step functions have run under, the count the
reference's jit cache holds for the same traffic.  Ends with one JSON line
of the numbers and of the kernels' launch counts.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import api, core
from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernels
from repro_torch.serve import FitServeConfig, FitServeEngine


def trace(n_requests: int = 100, seed: int = 0):
    """The reference's ragged trace: noisy cubics of 20 to 5000 points."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_requests):
        n = int(np.exp(rng.uniform(np.log(20), np.log(5000))))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        y = (1.0 + 0.5 * x - 0.8 * x**2 + 0.3 * x**3
             + rng.normal(0, 0.2, n)).astype(np.float32)
        out.append((x, y))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    kernels.reset_launch_counts()
    engine = FitServeEngine(FitServeConfig(
        degree=3, n_slots=8, buckets=(256, 2048), ridge=1e-9), device=dev)
    warm = engine.warmup()   # run both buckets' steps + the solves up front

    reqs = [engine.submit(x, y) for x, y in trace()]
    t0 = time.perf_counter()
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    after_traffic = engine.compiled_executables()

    done = sum(r.done for r in reqs)
    pts = sum(r.n for r in reqs)
    print(f"served {done}/{len(reqs)} fits ({pts} points) in {dt:.2f}s "
          f"-> {done / dt:.0f} fits/s with "
          f"{after_traffic} compiled executables")

    # every served fit matches a direct polyfit on the same series
    worst = 0.0
    for r in reqs:
        ref = core.polyfit(torch.from_numpy(r.x).to(dev),
                           torch.from_numpy(r.y).to(dev), 3,
                           device=dev).coeffs.cpu().numpy()
        worst = max(worst, float(np.max(np.abs(r.coeffs - ref))))
    print(f"max |serve - direct polyfit| coefficient gap: {worst:.2e}")

    for r in reqs[:4]:
        print(f"  req {r.uid}: n={r.n:>5} R={r.r:.4f} "
              f"coeffs={np.round(r.coeffs, 3)}")
    assert worst < 1e-3

    # per-request FitSpec: the solve policy rides with the request — a
    # tighter condition cap or a nested lower degree each mint one new
    # step key (the spec is part of the key) and then coexist
    before = engine.compiled_executables()
    x, y = reqs[0].x, reqs[0].y
    tight = engine.submit(x, y, spec=api.FitSpec(
        degree=3, numerics=api.NumericsPolicy(solver="gauss",
                                              fallback="svd",
                                              cond_cap=10.0)))
    line = engine.submit(x, y, spec=api.FitSpec(degree=1))
    engine.run()
    novel = engine.compiled_executables() - before
    print(f"\nper-request specs (+{novel} one-time compiles):")
    print(f"  cond_cap=10 : fallback_used={tight.fallback_used} "
          f"coeffs={np.round(tight.coeffs, 3)}")
    print(f"  degree=1    : coeffs={np.round(line.coeffs, 3)} "
          "(nested, from the same degree-3 slot state)")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "device": str(dev), "served": done, "requests": len(reqs),
        "points": pts, "seconds": dt, "worst_gap": worst,
        "warmup_keys": warm, "new_keys_after_warmup": after_traffic - warm,
        "novel_spec_keys": novel, "novel_specs": 2,
        "coeffs": [r.coeffs.tolist() for r in reqs],
        "tight": {"fallback_used": bool(tight.fallback_used),
                  "coeffs": tight.coeffs.tolist()},
        "line": line.coeffs.tolist(),
        "launches": kernels.launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
