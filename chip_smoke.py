#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py

Run from the repo root on a machine with one CUDA card and nvcc.  Builds the
kernels from ``src/repro_torch/kernels/csrc``, then:

  phase 0  card, build time, device copy bandwidth (1 GiB copy, median of 10)
  phase 1  each kernel against its plain version at B=64, n=2^16+37,
           degrees 1, 3, 7, 20: f32, bf16, zero weights (true count vs Σw),
           ragged n, a tail series, compensated; rerun bit-equality
  phase 2  api.fit (degree 3, B=4096 series × 65536 points, f32) on the
           packed kernel, then fit_report_streamed on the report kernel,
           checked against the planted cubic and chunked float64 moments
  phase 3  api.fit (degree 7, one series of 2^28 points) on the plain
           kernel, plain and Kahan-compensated, Gram error vs float64
  phase 4  the paper's Table I data in float64: Σe² = 128.1999

Prints the kernels' JSON line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero on any failure, or when
CUDA is absent.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

TOL_KERNEL = 1e-5      # kernel vs plain (float64), max|Δ| / max|ref| per block
TOL_MAIN = 1e-4        # main-path checks against float64

PAPER_X = [39.206, 29.74, 21.31, 12.087, 1.812, 0.001]
PAPER_Y = [751.912, 567.121, 403.746, 221.738, 18.8418, 1.88672]
PAPER_SSE = 128.199937


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, reps=20):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, ref):
    """(max|Δ|, max|Δ| / max|ref|) in float64."""
    d = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return d, d / (scale if scale > 0 else 1.0)


def block_rel_err(got, ref):
    """max over series of max|Δ_b| / max|ref_b| on (B, ...) blocks."""
    g = got.double().flatten(1)
    r = ref.double().flatten(1)
    d = (g - r).abs().amax(1)
    s = r.abs().amax(1).clamp_min(1e-300)
    return (g - r).abs().max().item(), (d / s).max().item()


def chunked(torch, fn, n, chunk):
    """Sum of ``fn(lo, hi)`` over n-chunks (the float64 references)."""
    out = None
    for lo in range(0, n, chunk):
        part = fn(lo, min(lo + chunk, n))
        out = part if out is None else out + part
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import api, core, engine
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import moments as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---------------------------------------------------------------- phase 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _, ptxas = build.build()
    build.library()
    build_s = time.perf_counter() - t0
    log(f"phase0 card: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; kernels built in {build_s:.1f} s")
    print(ptxas, file=sys.stderr)
    src = torch.empty(1 << 28, dtype=torch.float32, device=dev).fill_(1.0)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(src), reps=10)
    copy_bw = 2 * src.numel() * 4 / (copy_ms * 1e-3)   # read + write
    log(f"phase0 copy 1 GiB: {copy_ms:.4f} ms = {copy_bw / 1e9:.1f} GB/s "
        "(read + write)")
    del src, dst
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(shape, lo=-2.0, hi=2.0, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo)
                + lo).to(dtype)

    worst = {"moments_plain": 0.0, "moments_packed": 0.0,
             "fused_report": 0.0}
    for b, n in ((64, (1 << 16) + 37), (67, 77)):
        x = uniform((b, n))
        y = uniform((b, n))
        wz = (torch.rand((b, n), generator=gen, device=dev) > 0.3).float() \
            * uniform((b, n), 0.0, 2.0)
        for degree in (1, 3, 7, 20):
            cases = [("f32", x, y, None, False),
                     ("bf16", x.bfloat16(), y.bfloat16(), None, False),
                     ("weights", x, y, wz, False),
                     ("kahan", x, y, None, True)]
            for label, xc, yc, wc, comp in cases:
                ref = K.moments_block_plain(xc, yc, wc, degree,
                                             torch.float64)
                for name, fn in (("moments_plain", K.moments_plain),
                                 ("moments_packed", K.moments_packed)):
                    got = fn(xc, yc, wc, degree=degree, compensated=comp)
                    _, rel = block_rel_err(got, ref)
                    require(rel <= TOL_KERNEL,
                            f"{name} deg {degree} {label} B={b} n={n}: "
                            f"rel {rel:.3e}")
                    worst[name] = max(worst[name], rel)
                coeffs = uniform((b, degree + 1), -1.0, 1.0)
                rref = K.fused_report_plain(xc, yc, wc, coeffs,
                                            torch.float64)
                rgot = K.fused_report(xc, yc, wc, coeffs)
                _, rel = block_rel_err(rgot.T, rref.T)
                require(rel <= TOL_KERNEL,
                        f"fused_report deg {degree} {label}: rel {rel:.3e}")
                worst["fused_report"] = max(worst["fused_report"], rel)
            # true count vs Σw through the wrapper
            mw = ops.moments(x, y, degree, weights=wz)
            require(torch.equal(mw.count, (wz != 0).sum(-1).float()),
                    "true count")
            _, rel = rel_err(mw.weight_sum, wz.double().sum(-1))
            require(rel <= TOL_KERNEL, f"weight_sum rel {rel:.3e}")
        again = K.moments_packed(x, y, degree=3)
        require(torch.equal(again, K.moments_packed(x, y, degree=3)),
                "moments_packed rerun is not bit-equal")
    log("phase1 kernel vs plain max rel err: " + json.dumps(worst))

    # ---------------------------------------------------------------- phase 2
    B2, N2 = 4096, 1 << 16
    planted = torch.tensor([0.5, -1.0, 0.25, 0.75], device=dev)
    x2 = uniform((B2, N2))
    y2 = core.evaluate(planted, x2) + 0.1 * torch.randn(
        (B2, N2), generator=gen, device=dev)
    spec = api.FitSpec(degree=3)
    plan2 = spec.plan(tuple(x2.shape), x2.dtype, device=dev)
    require(plan2.path == engine.KERNEL_PACKED, f"phase2 plan {plan2.path}")
    K.reset_launch_counts()
    res2 = api.fit(x2, y2, spec)
    rep2 = core.fit_report_streamed(res2.poly, x2, y2)
    torch.cuda.synchronize()
    launches2 = K.launch_counts()
    require(launches2["moments_packed"] >= 1, "moments_packed not launched")
    require(launches2["fused_report"] >= 1, "fused_report not launched")
    c2 = res2.poly.coeffs
    require(c2.shape == (B2, 4) and bool(torch.isfinite(c2).all()),
            "phase2 coefficients finite, (B, 4)")
    planted_err = (c2 - planted).abs().max().item()
    require(planted_err <= 2e-2, f"planted cubic err {planted_err:.3e}")

    def plain64(xs, ys, degree, lo, hi):
        return K.moments_block_plain(xs[:, lo:hi], ys[:, lo:hi], None, degree,
                                     torch.float64)

    g64 = chunked(torch, lambda lo, hi: plain64(x2, y2, 3, lo, hi), N2, 8192)
    c64 = torch.linalg.solve(g64[:, :4, :4], g64[:, :4, 4])
    _, coef_rel = rel_err(c2, c64)
    require(coef_rel <= 1e-3, f"phase2 coeffs vs f64 solve rel {coef_rel:.3e}")
    s64 = chunked(torch, lambda lo, hi: K.fused_report_plain(
        x2[:, lo:hi], y2[:, lo:hi], None, c2.double(), torch.float64),
        N2, 8192)
    sw, sy, syy, sf, sff, syf, sse = s64.unbind(-1)
    r64 = (syf - sy * sf / sw) / torch.sqrt(
        (syy - sy * sy / sw) * (sff - sf * sf / sw))
    r_rel = ((rep2.r.double() - r64).abs() / r64.abs()).max().item()
    sse_rel = ((rep2.sse.double() - sse).abs() / sse.abs()).max().item()
    require(sse_rel <= TOL_MAIN, f"phase2 SSE rel {sse_rel:.3e}")
    require(r_rel <= TOL_MAIN, f"phase2 R rel {r_rel:.3e}")
    log(f"phase2 plan {plan2.describe()}; planted err {planted_err:.3e}; "
        f"coeffs vs f64 {coef_rel:.3e}; SSE rel {sse_rel:.3e}; "
        f"R rel {r_rel:.3e}; launches {launches2}")

    # kernels at the main-path shapes: vs the plain version in float64,
    # times of kernel and plain version (float32)
    rows = {}
    got = K.moments_packed(x2, y2, degree=3)
    abs_e, rel = block_rel_err(got, g64)
    require(rel <= TOL_KERNEL, f"moments_packed main shape rel {rel:.3e}")
    rows["moments_packed"] = dict(
        max_abs_err=abs_e, max_rel_err=rel,
        ms=cuda_ms(torch, lambda: K.moments_packed(x2, y2, degree=3)),
        plain_ms=cuda_ms(torch, lambda: K.moments_block_plain(
            x2, y2, None, 3)),
        bytes=2 * x2.numel() * 4 + B2 * 25 * 4,
        flops=(6 * 3 + 6) * x2.numel(), shape=f"B={B2} n={N2} deg 3 f32")
    cf = c2.contiguous()
    got = K.fused_report(x2, y2, None, cf)
    abs_e, rel = block_rel_err(got.T, chunked(torch, lambda lo, hi:
                                              K.fused_report_plain(
        x2[:, lo:hi], y2[:, lo:hi], None, cf.double(), torch.float64),
        N2, 8192).T)
    require(rel <= TOL_MAIN, f"fused_report main shape rel {rel:.3e}")
    rows["fused_report"] = dict(
        max_abs_err=abs_e, max_rel_err=rel,
        ms=cuda_ms(torch, lambda: K.fused_report(x2, y2, None, cf)),
        plain_ms=cuda_ms(torch, lambda: K.fused_report_plain(
            x2, y2, None, cf)),
        bytes=2 * x2.numel() * 4 + B2 * 4 * 4 + B2 * 7 * 4,
        flops=(2 * 3 + 15) * x2.numel(), shape=f"B={B2} n={N2} deg 3 f32")
    fit2_ms = statistics.median(
        _host_ms(torch, lambda: api.fit(x2, y2, spec)) for _ in range(5))
    rep2_ms = statistics.median(
        _host_ms(torch, lambda: core.fit_report_streamed(res2.poly, x2, y2))
        for _ in range(5))
    log(f"phase2 api.fit {fit2_ms:.3f} ms; fit_report_streamed "
        f"{rep2_ms:.3f} ms (host clock, median of 5)")
    del x2, y2, g64, s64, got
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 3
    N3 = 1 << 28
    planted7 = torch.tensor([0.3, -0.8, 0.5, 0.2, -0.4, 0.1, 0.05, -0.02],
                            device=dev)
    x3 = uniform((N3,))
    y3 = core.evaluate(planted7, x3) + 0.1 * torch.randn(
        (N3,), generator=gen, device=dev)
    spec3 = api.FitSpec(degree=7)
    spec3c = api.FitSpec(degree=7, numerics=api.NumericsPolicy(
        solver="auto", compensated=True))
    plan3 = spec3.plan(tuple(x3.shape), x3.dtype, device=dev)
    require(plan3.path == engine.KERNEL_PLAIN and plan3.numerics.normalize
            and plan3.numerics.solver == "cholesky",
            f"phase3 plan {plan3.describe()}")
    K.reset_launch_counts()
    res3 = api.fit(x3, y3, spec3)
    res3c = api.fit(x3, y3, spec3c)
    torch.cuda.synchronize()
    launches3 = K.launch_counts()
    require(launches3["moments_plain"] >= 2, "moments_plain not launched")
    grid = torch.linspace(-2.0, 2.0, 1001, device=dev)
    for r in (res3, res3c):
        require(bool(torch.isfinite(r.poly.coeffs).all()),
                "phase3 coeffs finite")
        err = (r.poly(grid) - core.evaluate(planted7, grid)).abs().max().item()
        require(err <= 1e-2, f"phase3 planted values err {err:.3e}")
    xt = core.Domain.from_data(x3).apply(x3)[None]
    yt = y3[None]
    g64 = chunked(torch, lambda lo, hi: plain64(xt, yt, 7, lo, hi), N3,
                  1 << 23)
    gu = K.moments_plain(xt, yt, degree=7)
    gc = K.moments_plain(xt, yt, degree=7, compensated=True)
    abs_u, rel_u = rel_err(gu, g64)
    _, rel_c = rel_err(gc, g64)
    require(rel_u <= TOL_MAIN, f"phase3 uncompensated Gram rel {rel_u:.3e}")
    require(rel_c <= rel_u and rel_c <= 1e-6,
            f"phase3 compensated Gram rel {rel_c:.3e} (plain {rel_u:.3e})")
    log(f"phase3 plan {plan3.describe()}; Gram rel err vs f64: "
        f"{rel_u:.3e} plain, {rel_c:.3e} compensated; launches {launches3}")
    rows["moments_plain"] = dict(
        max_abs_err=abs_u, max_rel_err=rel_u,
        ms=cuda_ms(torch, lambda: K.moments_plain(xt, yt, degree=7)),
        plain_ms=cuda_ms(torch, lambda: K.moments_block_plain(
            xt, yt, None, 7), reps=5),
        bytes=2 * N3 * 4 + 81 * 4, flops=(6 * 7 + 6) * N3,
        shape="B=1 n=2^28 deg 7 f32")
    rows["moments_plain"]["kahan_ms"] = cuda_ms(
        torch, lambda: K.moments_plain(xt, yt, degree=7, compensated=True))
    fit3_ms = statistics.median(
        _host_ms(torch, lambda: api.fit(x3, y3, spec3)) for _ in range(5))
    log(f"phase3 api.fit {fit3_ms:.3f} ms (host clock, median of 5)")
    del x3, y3, xt, yt, g64, gu, gc
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 4
    x4 = torch.tensor(PAPER_X, dtype=torch.float64, device=dev)
    y4 = torch.tensor(PAPER_Y, dtype=torch.float64, device=dev)
    res4 = api.fit(x4, y4, api.FitSpec(degree=3))
    sse4 = core.fit_report(res4.poly, x4, y4).sse.item()
    require(abs(sse4 - PAPER_SSE) / PAPER_SSE <= 1e-4,
            f"paper Σe² {sse4} vs {PAPER_SSE}")
    log(f"phase4 paper Table I, degree 3, f64: Σe² = {sse4:.6f}")

    # ----------------------------------------------------------------- report
    replaces = {   # the TPU kernel bodies in the JAX reference
        "moments_plain": ("src/repro/kernels/moments.py:133",
                          "_moments_kernel"),
        "moments_packed": ("src/repro/kernels/moments.py:185",
                           "_packed_moments_kernel"),
        "fused_report": ("src/repro/kernels/moments.py:251",
                         "_fused_report_kernel")}
    launches = {k: launches2[k] + launches3[k] for k in launches2}
    kernels = []
    for name in ("moments_plain", "moments_packed", "fused_report"):
        r = rows[name]
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["flops"] / PEAK_F32_FLOPS * 1e3
        require(launches[name] >= 1, f"{name} not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moments.cu",
            "replaces": replaces[name][0], "jax_body": replaces[name][1],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "phase1_max_rel_err": worst[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": r["shape"],
            "gb_per_s": r["bytes"] / (r["ms"] * 1e-3) / 1e9,
            "of_copy_rate": r["bytes"] / (r["ms"] * 1e-3) / copy_bw,
            "copy_bound_ms": r["bytes"] / copy_bw * 1e3,
            **({"kahan_ms": r["kahan_ms"]} if "kahan_ms" in r else {})})
    log(f"end to end: api.fit phase2 {fit2_ms:.3f} ms, phase3 "
        f"{fit3_ms:.3f} ms; copy {copy_bw / 1e9:.1f} GB/s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _host_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


if __name__ == "__main__":
    sys.exit(main())
