"""Quickstart on the PyTorch port: the paper's algorithm end to end on its
own dataset (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py           # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Prints the reference's lines, then one JSON line of the numbers and of
the kernels' launch counts (``repro_torch.kernels.moments``).
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch import core
from repro_torch.core import streaming
from repro_torch.data import curve_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import moments as kernels

# Table I dataset
TABLE_X = [39.206, 29.74, 21.31, 12.087, 1.812, 0.001]
TABLE_Y = [751.912, 567.121, 403.746, 221.738, 18.8418, 1.88672]


def host(t) -> list:
    return t.detach().cpu().tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (no CPU fallback)")
    dev = resolve_device(ap.parse_args(argv).device)
    kernels.reset_launch_counts()
    out = {"device": str(dev)}

    x = torch.tensor(TABLE_X, dtype=torch.float32, device=dev)
    y = torch.tensor(TABLE_Y, dtype=torch.float32, device=dev)

    print("=== Matricized LSE fit (paper-faithful: Gram + Gaussian elim) ===")
    out["table1"] = {}
    for order in (1, 2, 3):
        poly = core.polyfit(x, y, order, device=dev)     # the paper's path
        qr = core.polyfit(x, y, order, solver="qr_vandermonde",
                          device=dev)                    # MATLAB baseline
        rep = core.fit_report(poly, x, y)
        print(f"order {order}: coeffs     = {host(poly.coeffs)}")
        print(f"         polyfit(QR) = {host(qr.coeffs)}")
        print(f"         R = {float(rep.r):.4f}   Σe² = {float(rep.sse):.4f}")
        out["table1"][str(order)] = {
            "coeffs": host(poly.coeffs), "qr": host(qr.coeffs),
            "r": float(rep.r), "sse": float(rep.sse),
            "cond": float(poly.diagnostics.condition)}

    print("\n=== The matricization identity: A == VᵀV, B == Vᵀy ===")
    m = core.gram_moments(x, y, 3)
    s = core.power_sums(x, 3)
    hankel = bool(torch.allclose(core.hankel_from_power_sums(s, 3), m.gram))
    print("Hankel(power sums) == Gram:", hankel)
    out["hankel_equals_gram"] = hankel

    print("\n=== Beyond-paper hardening: normalized domain + Chebyshev ===")
    hard = core.polyfit(x, y, 3, normalize=True, device=dev)
    print("normalized-domain fit, raw coeffs:", host(hard.monomial_coeffs()))
    cheb = core.polyfit(x, y, 3, normalize=True, basis=core.CHEBYSHEV,
                        device=dev)
    cheb_sse = float(core.fit_report(cheb, x, y).sse)
    print("chebyshev-basis Σe²:", cheb_sse)
    out["normalized_monomial"] = host(hard.monomial_coeffs())
    out["chebyshev_sse"] = cheb_sse

    print("\n=== CUDA kernel path (the plain version on the CPU) ===")
    # engine="auto" picks the path from shape/basis/device (repro_torch.
    # engine); force the kernel here so the six points still exercise it
    pk = core.polyfit(x, y, 3, engine="kernel", device=dev)
    print("kernel-accumulated coeffs:", host(pk.coeffs))
    out["kernel_coeffs"] = host(pk.coeffs)

    print("\n=== Streaming fit: O(1) state over a 1M-point stream ===")
    xs, ys, true = curve_dataset(1_000_000, degree=2, noise=5.0, seed=0,
                                 device=dev)
    state = streaming.StreamState.create(2, device=dev)
    for lo in range(0, xs.shape[0], 65536):
        state = streaming.update(state, xs[lo:lo + 65536],
                                 ys[lo:lo + 65536])
    fit = streaming.current_fit(state)
    floats = sum(t.numel() for t in (*vars(state.moments).values(),
                                     state.decay))
    print("true coeffs     :", host(true))
    print("streamed coeffs :", host(fit.coeffs), f"(state: {floats} floats)")
    out["stream"] = {"points": int(xs.shape[0]), "true": host(true),
                     "coeffs": host(fit.coeffs), "state_floats": floats}

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["launches"] = kernels.launch_counts()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
