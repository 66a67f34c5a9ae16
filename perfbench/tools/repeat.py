"""Run one cell several times, each run a process of its own as the
benchmark's check runs it, and keep each run's result line and the end of its
standard error.

    python3 perfbench/tools/repeat.py --workload batch.packed \
        --seeds 11,12,13 --seconds 20 --trace 0 --tag set1

Writes ``<out>/<tag>.jsonl`` (``--out``, default ``perfbench_results``):
one line a run (seed, exit code, wall seconds, the result, the stderr
tail); prints a summary.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default="perfbench_results",
                    help="directory of the records, from the checkout's root")
    a = ap.parse_args(argv)
    out = ROOT / a.out
    out.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    with open(out / f"{a.tag}.jsonl", "a") as f:
        for seed in a.seeds.split(","):
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "perfbench/run.py", "--workload",
                 a.workload, "--seed", seed, "--seconds", str(a.seconds),
                 "--trace", str(a.trace)], cwd=ROOT, capture_output=True,
                text=True)
            wall = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                res = None
            rec = {"workload": a.workload, "seed": int(seed),
                   "trace": a.trace, "rc": p.returncode, "wall_s": wall,
                   "result": res, "stderr": p.stderr[-4000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            m = res["metrics"] if res else {}
            print(f"{a.workload} seed={seed} rc={p.returncode} "
                  f"wall={wall:.1f}s correct={res and res['correct']} "
                  + " ".join(f"{k}={v['value']:.6g}" for k, v in m.items())
                  + (" checks=" + json.dumps(res["checks"]) if res else "")
                  + ("" if res else "\n" + p.stderr[-3000:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
