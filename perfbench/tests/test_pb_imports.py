"""What the chip path loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (compared whole:
``repro_torch`` is the port); and the reference imports nothing of the
program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from pbench import runner

BENCH = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    mods = ["repro_torch", "repro_torch.api", "reprox", "numpy"]
    assert runner.forbidden_modules(mods) == []
    assert runner.forbidden_modules(mods + ["repro.core", "jax._src"]) == \
        ["jax._src", "repro.core"]


def test_a_run_loads_neither_jax_nor_repro():
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r},
                {str(BENCH.parent / 'src')!r}]
import pb_small
from pbench import runner
r = pb_small.run("batch.packed", seconds=0.2)
print(json.dumps({{"correct": r["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "bad": runner.forbidden_modules()}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["bad"] == []
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        assert _imports(f) <= {"__future__", "dataclasses", "numpy",
                               "torch"}, f


def test_harness_sources_import_no_jax():
    for f in BENCH.rglob("*.py"):
        assert not {"jax", "jaxlib", "flax", "repro"} & _imports(f), f
