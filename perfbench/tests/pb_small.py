"""Small sizes at which every cell runs on the CPU in a test, and a run
helper.  The limits are the cells' own (``limits/<cell>.json``).

Each system's settings are a file of their own, ``small/<system>.py``,
found by the system that the cell's configuration names: ``SECONDS`` (a
run's window), ``overrides(cell)`` (the configuration and traffic keys a
CPU run changes) and ``FAULTS`` (``pb_faults.py``).  A new system adds
that file; nothing here names one.
"""
from __future__ import annotations

import functools
import time
from pathlib import Path

from pbench import cells, runner

SMALL = Path(__file__).resolve().parent / "small"
CELLS = [w["name"] for w in
         cells.load_json(cells.ROOT / "BENCHMARK.json")["workloads"]]


def system(cell: str) -> str:
    return cells.load_cell(cell).system


def small_file(system_name: str) -> Path:
    return SMALL / f"{system_name}.py"


@functools.cache
def system_settings(system_name: str):
    """The module ``small/<system>.py``."""
    path = small_file(system_name)
    if not path.is_file():
        raise FileNotFoundError(
            f"system {system_name!r} has no small-run settings: add "
            f"perfbench/tests/small/{system_name}.py (SECONDS, "
            f"overrides(cell), FAULTS)")
    return cells.load_module(path, f"perfbench_small_{system_name}")


def settings(cell: str):
    return system_settings(system(cell))


def faults(cell: str) -> tuple:
    """The names of the faults the cell's system can have; none where the
    system has no settings file (a test of its own says so)."""
    if not small_file(system(cell)).is_file():
        return ()
    return tuple(settings(cell).FAULTS)


def overrides(cell: str) -> dict:
    return settings(cell).overrides(cells.load_cell(cell))


def run(cell: str, seed: int = 2**31 + 11, trace: bool = False,
        seconds: float | None = None, **extra) -> dict:
    ov = overrides(cell)
    ov.update(extra)
    return runner.run_cell(cell, seed, seconds or settings(cell).SECONDS,
                           trace, "cpu", t_start=time.perf_counter(),
                           overrides=ov)
