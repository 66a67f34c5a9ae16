"""The spread of each metric over the runs of a set, as the bounds are
set from it: (third quartile - first quartile) / median, the quartiles
of ``statistics.quantiles(values, n=4)``.

    python3 perfbench/tools/spread.py perfbench_results/set1.jsonl \
        perfbench_results/set2.jsonl

Prints, for each file and metric, the values, the median and the spread,
then the wider spread of the files and five times it.
"""
from __future__ import annotations

import json
import statistics
import sys


def spreads(path: str) -> dict:
    vals: dict = {}
    for line in open(path):
        rec = json.loads(line)
        res = rec.get("result")
        if not res or rec.get("trace"):
            continue
        for k, m in res["metrics"].items():
            vals.setdefault((rec["workload"], k), []).append(m["value"])
    out = {}
    for key, v in vals.items():
        if len(v) < 3:
            continue
        q1, med, q3 = statistics.quantiles(v, n=4)
        out[key] = (v, med, (q3 - q1) / med)
    return out


def main(paths) -> int:
    widest: dict = {}
    for p in paths:
        for key, (v, med, sp) in sorted(spreads(p).items()):
            print(f"{p} {key[0]} {key[1]}: n={len(v)} median={med!r} "
                  f"spread={sp:.5f} values={v}")
            widest[key] = max(widest.get(key, 0.0), sp)
    for key, sp in sorted(widest.items()):
        print(f"WIDEST {key[0]} {key[1]}: {sp:.5f} -> 5x = {5 * sp:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
