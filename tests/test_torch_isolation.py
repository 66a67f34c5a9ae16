"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no ``examples/torch_*.py`` imports jax, jaxlib or
the reference package ``repro``, and importing the port leaves jax out of
``sys.modules``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_has_files_to_scan():
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_reference_or_jax_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, importlib\n"
            "for m in ('repro_torch', 'repro_torch.api', 'repro_torch.core',"
            " 'repro_torch.engine', 'repro_torch.kernels.ops',"
            " 'repro_torch.kernels.build', 'repro_torch.interop',"
            " 'repro_torch.serve', 'repro_torch.obs',"
            " 'repro_torch.launch.serve', 'repro_torch.runtime',"
            " 'repro_torch.train', 'repro_torch.serve.fleet',"
            " 'repro_torch.core.distributed', 'repro_torch.launch.mesh',"
            " 'repro_torch.configs', 'repro_torch.models',"
            " 'repro_torch.serve.engine', 'repro_torch.core.scaling_laws',"
            " 'repro_torch.data', 'repro_torch.checkpoint',"
            " 'repro_torch.launch.train', 'repro_torch.launch.roofline',"
            " 'repro_torch.launch.perfgate', 'repro_torch.models.gla',"
            " 'repro_torch.models.rwkv6', 'repro_torch.models.rwkv6_model',"
            " 'repro_torch.models.mamba2', 'repro_torch.models.zamba2',"
            " 'repro_torch.models.encdec', 'repro_torch.sharding',"
            " 'repro_torch.launch.dryrun', 'repro_torch.analysis',"
            " 'repro_torch.analysis.core', 'repro_torch.analysis.determinism',"
            " 'repro_torch.analysis.protocol',"
            " 'repro_torch.analysis.numerics',"
            " 'repro_torch.analysis.jit_hazards',"
            " 'repro_torch.analysis.sanitizers',"
            " 'repro_torch.analysis.__main__'):\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.train", "repro_torch.launch.train", "repro_torch.data",
    "repro_torch.checkpoint", "repro_torch.launch.perfgate",
    "repro_torch.runtime", "repro_torch.models.zamba2",
    "repro_torch.models.encdec", "repro_torch.sharding",
    "repro_torch.launch.dryrun", "repro_torch.analysis"])
def test_each_entry_module_imports_first(module):
    """Each module imports in a fresh process as the first import (the
    train launcher imports ``repro_torch.train`` before ``core``)."""
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
