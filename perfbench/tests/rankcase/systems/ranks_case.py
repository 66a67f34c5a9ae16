"""Rank 0 and the peers of ``test_pb_ranks.py``: a stand-in cell of four
ranks with no configuration of its own, run through ``runner.run_cell``
and joined by ``pbench/ranks.py``.

    PB_RANKS_CASE=<case> \
        python perfbench/tests/rankcase/systems/ranks_case.py <device>

Rank 0 finds this file as its cell's system driver (``cells.BENCH`` is
this file's ``rankcase/``), prints its peers' pids as one JSON line,
all-reduces the ranks' ids with them, prints the sum as another, and
ends its ``run``; then it prints the result line as ``run.py`` does.
The case, read from the environment by every rank, breaks one thing:

* ``sound``: nothing;
* ``raise_at_start``: each peer raises as it loads this file, before it
  joins the group;
* ``raise_in_collective``: peer 3 raises while the others wait in the
  all-reduce;
* ``rank0_waits``: every rank sleeps, outside any collective, so that
  only the peers' watch on rank 0 can end them (the test kills rank 0);
* ``forbidden``: each peer has a module named ``jax`` loaded at its end;
* ``forbidden_left_open``: as ``forbidden``, but the driver does not
  close its group, so the harness has to.
"""
from __future__ import annotations

import json
import os
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve()
BENCH = HERE.parents[3]
for _p in (str(BENCH), str(BENCH.parent / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

CASE = os.environ.get("PB_RANKS_CASE", "sound")
WORLD = 4

if CASE == "raise_at_start" and __name__.startswith("perfbench_peer_"):
    raise RuntimeError("this peer fails as it starts")


def peer(ctx) -> None:
    import torch.distributed as dist
    if CASE == "rank0_waits":
        time.sleep(3600)
    if CASE == "raise_in_collective" and ctx.rank == 3:
        time.sleep(1.0)
        raise RuntimeError("peer 3 fails while the others wait")
    if CASE.startswith("forbidden"):
        sys.modules["jax"] = types.ModuleType("jax")
    t = ctx.torch.tensor([float(ctx.rank)], device=ctx.device)
    dist.all_reduce(t)


def _all_reduce(ctx, group) -> None:
    import torch.distributed as dist
    print(json.dumps({"pids": group.pids}), flush=True)
    if CASE == "rank0_waits":
        time.sleep(3600)
    t = ctx.torch.tensor([0.0], device=ctx.device)
    dist.all_reduce(t)
    print(json.dumps({"sum": float(t.item())}), flush=True)


def run(ctx) -> dict:
    from pbench import ranks
    window_start = time.perf_counter()
    group = ranks.start(ctx)
    if CASE == "forbidden_left_open":
        _all_reduce(ctx, group)
    else:
        with group:
            _all_reduce(ctx, group)
    return {"window_start": window_start, "attempted": 1, "failed": 0,
            "memory_peak_bytes": 0, "e2e": {}, "checks": {}}


def main(device: str) -> int:
    from pbench import cells, runner
    cell = cells.Cell(name="ranks.case", chips=WORLD,
                      config={"system": "ranks_case"}, traffic={},
                      limits={}, end_to_end=[], per_layer=[])
    cells.BENCH = HERE.parents[1]
    cells.load_cell = lambda name, bench=None: cell
    result = runner.run_cell(cell.name, 1, 1.0, False, device,
                             t_start=time.perf_counter())
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "cpu"))
