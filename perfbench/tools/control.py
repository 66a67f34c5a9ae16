"""Read the numbers that decide ``correct`` from the control: the plain
reference computed one precision below the configuration's (bfloat16
inputs and stored sums, float32 solve), put in the program's place, at
the cell's own size, on each seed given.  The upper reading of each
limit is the smallest value the control gives over the seeds.

    python3 perfbench/tools/control.py --workload batch.packed \
        --seeds 1,2,3

Writes ``<out>/control_<workload>.jsonl`` (``--out``, default
``perfbench_results``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbench import cells, devtrace, runner                     # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="perfbench_results",
                    help="directory of the records, from the checkout's root")
    a = ap.parse_args(argv)
    runner.set_cache_dirs(BENCH.parent)
    import torch
    cell = cells.load_cell(a.workload)
    driver = cells.system_driver(cell)
    out = BENCH.parent / a.out
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"control_{a.workload}.jsonl", "a") as f:
        for seed in a.seeds.split(","):
            ctx = runner.Ctx(torch=torch, device=torch.device(a.device),
                             cell=cell, seed=int(seed), seconds=1.0,
                             trace=False, spans=devtrace.Spans(),
                             overrides={})
            t = time.perf_counter()
            readings = driver.control(ctx)
            rec = {"workload": a.workload, "seed": int(seed),
                   "control": readings, "limits": cell.limits,
                   "seconds": time.perf_counter() - t}
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
