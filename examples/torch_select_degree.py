"""Single-pass automatic degree selection, offline and streaming, on the
PyTorch port (the counterpart of ``examples/select_degree.py``).

    PYTHONPATH=src python examples/torch_select_degree.py           # CUDA
    PYTHONPATH=src python examples/torch_select_degree.py --device cpu

A cubic is planted under noise; the selector sees the degree-8 candidate
ladder.  ONE moment accumulation carries the whole ladder (the moment
counter reads 1 call), and the raw SSE column keeps falling while
AICc/BIC/CV reject the overfit.  Ends with one JSON line of the numbers
and of the kernels' launch counts.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import core, engine
from repro_torch.core import streaming
from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernels

MAX_DEGREE = 8


def data(n: int = 4096, seed: int = 0):
    """The reference's planted cubic at SNR 10, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, n)
    true = np.array([1.0, -0.5, 0.3, 0.9])
    signal = np.polyval(true[::-1], x)
    y = signal + (np.std(signal) / 10.0) * rng.normal(0, 1, n)
    return x.astype(np.float32), y.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    kernels.reset_launch_counts()
    xh, yh = data()
    n = xh.shape[0]
    x = torch.from_numpy(xh).to(dev)
    y = torch.from_numpy(yh).to(dev)

    print("=== One-pass selection over the degree ladder (folds=5) ===")
    engine.reset_moment_counter()
    sel = core.select_degree(x, y, max_degree=MAX_DEGREE, folds=5,
                             device=dev)
    counter = engine.moment_counter()
    print(f"moment-producing calls: {counter['calls']} "
          f"(points touched: {counter['points']})")
    s = sel.sweep.scores
    cols = {k: s.by_name(k).detach().cpu().numpy().astype(float)
            for k in ("sse", "aicc", "bic", "cv")}
    print(f"{'deg':>3} {'SSE':>10} {'AICc':>10} {'BIC':>10} {'CV':>10}")
    for d in range(MAX_DEGREE + 1):
        mark = "  <- chosen" if d == sel.best_degree else ""
        print(f"{d:>3} {cols['sse'][d]:>10.3f} {cols['aicc'][d]:>10.1f} "
              f"{cols['bic'][d]:>10.1f} {cols['cv'][d]:>10.3f}{mark}")
    print(f"chosen: degree {sel.best_degree} by {sel.criterion} "
          f"(SSE alone would pick {int(np.argmin(cols['sse']))} — "
          "monotone, always the overfit)")
    coeffs = sel.poly.coeffs.detach().cpu().tolist()
    print("coeffs:", coeffs)

    print("\n=== The same, via the fitting front door ===")
    poly = core.polyfit(x, y, "auto", device=dev)
    print(f"polyfit(x, y, 'auto') -> degree {poly.degree}")

    print("\n=== Streaming: the running best degree as data arrives ===")
    state = streaming.StreamState.create(MAX_DEGREE, cv_folds=5, device=dev)
    chunk = 128
    for i, lo in enumerate(range(0, n, chunk)):
        state = streaming.update(state, x[lo:lo + chunk], y[lo:lo + chunk])
        if i % 4 == 3:
            cur = state.current_selection()
            aicc_best = state.current_selection(criterion="aicc").best_degree
            cv = cur.sweep.scores.cv.detach().cpu().tolist()
            print(f"after {lo + chunk:>5} pts: cv picks {cur.best_degree}, "
                  f"aicc picks {aicc_best}, cv scores (deg 2..5): "
                  + " ".join(f"{cv[d]:.3f}" for d in range(2, 6)))
    final = state.current_selection()
    print(f"final streaming selection: degree {final.best_degree} "
          f"(state is O(k·m²) — fold partials + running total, no history)")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "device": str(dev), "moment_calls": counter["calls"],
        "moment_points": counter["points"],
        "best_degree": int(sel.best_degree), "criterion": sel.criterion,
        "scores": {k: v.tolist() for k, v in cols.items()},
        "coeffs": coeffs, "auto_degree": int(poly.degree),
        "stream_degree": int(final.best_degree),
        "launches": kernels.launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
