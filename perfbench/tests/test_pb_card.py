"""On the card: each cell runs through the command, briefly, and comes
out correct.  Skips without a card (``-m cuda`` selects it)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from pbench import cells

BENCH = cells.load_json(cells.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(card, cell):
    import torch
    need = cells.load_cell(cell, BENCH).chips
    if torch.cuda.device_count() < need:
        pytest.skip(f"{cell} needs {need} cards")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "3",
                        "--trace", "0"], cwd=cells.ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
