"""The benchmark takes a cell of a new system, on four ranks, as added
files and ``BENCHMARK.json`` entries only.

A copy of ``BENCHMARK.json`` and ``perfbench/`` (``src`` linked) gets the
toy system of ``toy/`` (a driver with ``run``, ``peer`` and ``control``,
a configuration, limits, ``small/toy_fit.py`` with one fault and a
per-layer reader) and its entries: a cell on 4 ranks, listed under
``batch_gpts_per_s``.  The copy's own suite then passes, the toy's sound,
fault and control cases included, and every file of the original is in
the copy unchanged.
"""
from __future__ import annotations

import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TOY = Path(__file__).resolve().parent / "toy"
CELL = "toy.mesh"
ENTRIES = {
    "configs": {"name": "toyfit",
                "source": "https://arxiv.org/abs/1512.08017",
                "file": "perfbench/configs/toyfit.json", "reduced": [],
                "why": "a line through the points of four ranks"},
    "workloads": {"name": CELL, "config": "toyfit", "traffic": "packed",
                  "chips": 4,
                  "why": "four ranks, one all-reduce of five sums a call"},
    "per_layer": {"name": "toy.allreduce_ms", "unit": "ms",
                  "better": "lower", "source": "program_counter",
                  "layer": "toy exchange", "moves": "batch_gpts_per_s",
                  "workloads": [CELL]},
}
# the copy's suite leaves out this file (it would copy itself again) and
# the rank launcher's own tests, which ran outside on the same ranks.py
LEFT_OUT = ("test_pb_contract.py", "test_pb_ranks.py")
TIMEOUT_S = 240


def _files(top: Path) -> set:
    return {p.relative_to(top) for p in top.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _only_added(old, new, where="BENCHMARK.json") -> None:
    """``new`` is ``old`` with entries added at the ends of lists."""
    if isinstance(old, dict):
        assert isinstance(new, dict) and set(old) == set(new), where
        for k in old:
            _only_added(old[k], new[k], f"{where}.{k}")
    elif isinstance(old, list):
        assert isinstance(new, list) and len(new) >= len(old), where
        for i, v in enumerate(old):
            _only_added(v, new[i], f"{where}[{i}]")
    else:
        assert old == new, where


def _add_toy(copy: Path) -> set:
    added = set()
    for rel in _files(TOY):
        dest = copy / "perfbench" / rel
        assert not dest.exists(), f"the toy would replace {rel}"
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(TOY / rel, dest)
        added.add(rel)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    for key, entry in ENTRIES.items():
        bench[key].append(entry)
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "batch_gpts_per_s")
    rate["workloads"].append(CELL)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return added


def _copy(tmp_path: Path, leave_out=()) -> tuple[Path, set]:
    """A checkout of the benchmark with the toy added, less the toy's
    files ``leave_out``."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    (copy / "src").symlink_to(ROOT / "src")
    added = _add_toy(copy)
    for rel in leave_out:
        (copy / "perfbench" / rel).unlink()
    return copy, added - set(leave_out)


def _suite(copy: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         *args], cwd=copy, capture_output=True, text=True,
        timeout=TIMEOUT_S)


def test_a_four_rank_system_is_added_as_files_only(tmp_path):
    copy, added = _copy(tmp_path)
    old, new = _files(BENCH), _files(copy / "perfbench")
    assert new - old == added
    _, differ, missing = filecmp.cmpfiles(BENCH, copy / "perfbench",
                                          [str(p) for p in old],
                                          shallow=False)
    assert differ == [] and missing == []
    _only_added(json.loads((ROOT / "BENCHMARK.json").read_text()),
                json.loads((copy / "BENCHMARK.json").read_text()))

    p = _suite(copy, "perfbench/tests",
               *(f"--ignore=perfbench/tests/{f}" for f in LEFT_OUT))
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    for case in (f"test_sound_run_is_correct[{CELL}]",
                 f"test_fault_is_not_correct[{CELL}-answer_altered]",
                 f"test_control_reads_past_the_limits[{CELL}]",
                 f"test_cell_found_by_name[{CELL}]",
                 "test_system_has_small_settings[toy_fit]"):
        assert f"::{case} PASSED" in p.stdout, p.stdout[-4000:]


def test_a_system_without_small_settings_fails_one_named_test(tmp_path):
    """Without ``small/toy_fit.py`` the suite still collects: the batch
    cells' fault cases run, and the test of the settings names the
    missing file."""
    copy, _ = _copy(tmp_path, leave_out=[Path("tests/small/toy_fit.py")])
    p = _suite(copy, "perfbench/tests/test_pb_lookup.py",
               "perfbench/tests/test_pb_faults.py",
               "-k", "small_settings or fault_is_not_correct")
    assert p.returncode == 1, p.stdout[-4000:] + p.stderr[-2000:]
    assert "::test_system_has_small_settings[toy_fit] FAILED" in p.stdout
    assert "perfbench/tests/small/toy_fit.py is missing" in p.stdout
    assert ("::test_fault_is_not_correct[batch.packed-state_unchanged] "
            "PASSED") in p.stdout
    summary = p.stdout.strip().splitlines()[-1]
    assert "1 failed" in summary and "error" not in summary, summary
