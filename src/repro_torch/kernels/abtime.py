"""Time this checkout's kernels against another build of the kernel
library, on the same inputs, in turns, in one process.

    python -m repro_torch.kernels.abtime OTHER_LIB [--rounds 4] [--reps 30]

``OTHER_LIB`` is a ``librepro_kernels_*.so`` built from another checkout,
for example an earlier commit unpacked with ``git archive`` into
``_parent/`` (listed in ``.gitignore``) and built there:

    (cd _parent && PYTHONPATH=src python -c \\
        "from repro_torch.kernels import build; print(build.build()[0])")

Times taken in two processes on one card can differ by a fifth (each run
places its inputs anew), so the two builds are launched here on the very
same tensors: per round A, B, B, A, each the median CUDA-event time of
``reps`` launches.  A is ``OTHER_LIB``, B this checkout.  The kernels run
at the shapes of ``chip_smoke.py``'s main paths: ``moments_packed``, the
ring (``--block-n``, nbuf 2) and ``fused_report`` at B=4096 × n=65536,
degree 3, float32; ``moments_plain`` on one series of 2^28 points, degree
7.  Prints the card's name and power limit, then one JSON line per kernel:
each build's median over its runs, B/A, whether the two outputs have the
same bits, and every run's time.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels import moments as K


def _median_ms(fn, reps: int) -> float:
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


@contextlib.contextmanager
def _using(lib):
    """Route the launchers (which call ``build.library()``) to ``lib``."""
    real = build.library
    build.library = lambda: lib
    try:
        yield
    finally:
        build.library = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other build's shared library (A)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--block-n", type=int, default=512,
                    help="the ring's block (the tuner's choice on an H100)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("abtime: CUDA is not available", file=sys.stderr)
        return 2
    libs = {"a": build.load(args.other), "b": build.library()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev) * 4 - 2

    xp, yp = uniform((4096, 1 << 16)), uniform((4096, 1 << 16))
    x1, y1 = uniform((1, 1 << 28)) / 2, uniform((1, 1 << 28))
    coeffs = uniform((4096, 4)) / 2
    cases = {
        "moments_packed": lambda: K.moments_packed(xp, yp, degree=3),
        "moments_packed_ring": lambda: K.moments_packed_ring(
            xp, yp, degree=3, block_n=args.block_n, nbuf=2),
        "moments_plain": lambda: K.moments_plain(x1, y1, degree=7),
        "fused_report": lambda: K.fused_report(xp, yp, None, coeffs),
    }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for name, fn in cases.items():
        runs = {"a": [], "b": []}
        for _ in range(args.rounds):
            for tag in ("a", "b", "b", "a"):
                with _using(libs[tag]):
                    runs[tag].append(_median_ms(fn, args.reps))
        outs = {}
        for tag, lib in libs.items():
            with _using(lib):
                outs[tag] = fn()
        a_ms = statistics.median(runs["a"])
        b_ms = statistics.median(runs["b"])
        print(json.dumps({"kernel": name, "a": args.other, "a_ms": a_ms,
                          "b_ms": b_ms, "b_over_a": b_ms / a_ms,
                          "bit_equal": bool(torch.equal(outs["a"],
                                                        outs["b"])),
                          "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
