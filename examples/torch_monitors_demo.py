"""The paper's technique as framework telemetry on the PyTorch port:
loss-curve fitting, divergence detection, ETA, straggler detection,
scaling-law fits (the counterpart of ``examples/monitors_demo.py``).

    PYTHONPATH=src python examples/torch_monitors_demo.py           # CUDA
    PYTHONPATH=src python examples/torch_monitors_demo.py --device cpu

Ends with one JSON line of the numbers and of the kernels' launch counts.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import core
from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernels
from repro_torch.runtime import plan_reslice
from repro_torch.train import LossCurveMonitor, StepTimeMonitor


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    kernels.reset_launch_counts()

    print("=== Loss-curve monitor (streaming matricized LSE) ===")
    mon = LossCurveMonitor(degree=1, decay=0.995, device=dev)
    rng = np.random.default_rng(0)
    for step in range(300):
        loss = 6.0 * (step + 10) ** -0.15 + rng.normal(0, 0.02)
        mon.observe(step, loss)
    slope, pred = mon.slope_at(300), mon.predict(600)
    eta, diverging = mon.eta_to(4.0, 300), mon.diverging(300)
    print(f"fitted slope @300: {slope:+.2e} /step")
    print(f"predicted loss @600: {pred:.3f}")
    print(f"eta to loss 4.0: {eta} steps")
    print(f"diverging? {diverging}")

    print("\n=== Straggler detection + work re-slicing ===")
    st = StepTimeMonitor(n_hosts=8, threshold=1.3, device=dev)
    for step in range(25):
        t = 1.0 + rng.normal(0, 0.02, 8)
        t[3] = 1.6 + rng.normal(0, 0.05)        # host 3 is slow
        st.observe(step, t)
    stragglers = st.stragglers(25)
    print("stragglers:", stragglers)
    plan = plan_reslice(st, 25, global_batch=256)
    print("re-sliced per-host batch shares:", plan.shares)

    print("\n=== Scaling-law fit (log-log matricized LSE) ===")
    tokens = torch.from_numpy(np.logspace(7, 10, 40).astype(np.float32)) \
        .to(dev)
    loss = 2.57e3 * tokens ** -0.35 + 1.69     # chinchilla-ish synthetic
    law = core.fit_power_law(tokens, loss, device=dev)
    at = float(law(torch.tensor(1e11, device=dev)))
    print(f"fit: loss = {float(law.scale):.3g} · D^{float(law.exponent):.3f} "
          f"+ {float(law.offset):.2f}")
    print(f"predicted loss at 1e11 tokens: {at:.3f}")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(json.dumps({
        "device": str(dev), "slope": slope, "predict_600": pred,
        "eta": eta, "diverging": bool(diverging),
        "stragglers": [int(h) for h in stragglers],
        "shares": [float(s) for s in plan.shares],
        "power_law": {"scale": float(law.scale),
                      "exponent": float(law.exponent),
                      "offset": float(law.offset), "at_1e11": at},
        "launches": kernels.launch_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
