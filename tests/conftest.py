"""Session conftest: make the suite collect offline.

* Ensures ``src/`` is importable even when pytest is invoked without
  PYTHONPATH=src (pyproject's ``pythonpath`` handles the normal case; this
  covers direct ``pytest tests/...`` invocations from other cwds).
* Installs ``tests/_hypothesis_compat.py`` as the ``hypothesis`` module when
  the real package is unavailable (hermetic/offline environments), so the
  seven property-test modules collect and run on fixed example sets.
* Arms the recompile-counter tripwire (``repro.analysis.sanitizers``) when
  ``REPRO_RECOMPILE_TRIPWIRE=1``: any test marked ``no_recompile`` fails if
  it triggers an XLA executable compile — the serve warmup invariant,
  generalized to any test.  CI's ``lint-static`` job runs one pytest leg
  with the flag set.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

try:  # prefer the real thing when it exists
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis", os.path.join(os.path.dirname(__file__),
                                   "_hypothesis_compat.py"))
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules["hypothesis"] = _mod
    # `from hypothesis import strategies as st` resolves via attribute, but
    # register the submodule path too for plain `import hypothesis.strategies`.
    sys.modules["hypothesis.strategies"] = _mod.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "no_recompile: with REPRO_RECOMPILE_TRIPWIRE=1, fail this test if "
        "it triggers any XLA executable compile")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a CUDA kernel has no CPU mode); skips "
        "without one")


@pytest.fixture(autouse=True)
def _recompile_tripwire(request):
    if (os.environ.get("REPRO_RECOMPILE_TRIPWIRE") != "1"
            or request.node.get_closest_marker("no_recompile") is None):
        yield
        return
    from repro.analysis.sanitizers import CompileCounter
    with CompileCounter() as counter:
        yield
    if counter.count:
        pytest.fail(
            f"no_recompile test compiled {counter.count} executable(s): "
            f"{counter.names}")
