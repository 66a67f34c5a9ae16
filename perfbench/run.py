"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
mixes, metrics and limits are named in ``BENCHMARK.json`` and found by
name under ``perfbench/`` (``pbench/cells.py``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit, which also close standard error.

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, and when a module of ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                        # noqa: E402
import sys                                             # noqa: E402
from pathlib import Path                               # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import cells, runner                       # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    runner.set_cache_dirs(ROOT)
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        runner.log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        runner.log(f"{args.workload} needs {cell.chips} cards, "
                   f"{torch.cuda.device_count()} visible")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda:0", t_start=T_START)
    bad = runner.forbidden_modules()
    if bad:
        runner.log("modules of jax or the JAX package are loaded: "
                   + ", ".join(bad))
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
