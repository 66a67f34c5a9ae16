"""Small sizes at which every cell runs on the CPU in a test, by the
system its configuration names, and a run helper.  The limits are the
cells' own (``limits/<cell>.json``)."""
from __future__ import annotations

import time

from pbench import cells, runner

# a stream cell keeps its eight blocks: 512 points in blocks of 64
OVERRIDES = {
    "batch_fit": {"config": {"batch": 16, "points": 512}},
}
CHUNK = {"config": {"chunk_points": 64}}
SECONDS = {"batch_fit": 0.3}
# the faults of pb_faults.py that each system can have
FAULTS = {"batch_fit": ("state_unchanged", "half_batch", "answer_altered")}
CELLS = [w["name"] for w in
         cells.load_json(cells.ROOT / "BENCHMARK.json")["workloads"]]


def system(cell: str) -> str:
    return cells.load_cell(cell).system


def overrides(cell: str) -> dict:
    ov = {k: dict(v) for k, v in OVERRIDES[system(cell)].items()}
    if cells.load_cell(cell).config.get("chunk_points"):
        ov["config"].update(CHUNK["config"])
    return ov


def run(cell: str, seed: int = 2**31 + 11, trace: bool = False,
        seconds: float | None = None, **extra) -> dict:
    ov = overrides(cell)
    ov.update(extra)
    return runner.run_cell(cell, seed, seconds or SECONDS[system(cell)],
                           trace, "cpu", t_start=time.perf_counter(),
                           overrides=ov)
