"""Runtime sanitizer companions to the static checkers (port of
``repro.analysis.sanitizers``).

Two dynamic tripwires for the hazards the AST passes can only
approximate:

* :class:`CompileCounter` / :func:`assert_no_recompiles` — the dynamic
  twin of RL-RECOMPILE.  The port compiles nothing per step; what plays
  the jit cache's part is each ``StepFunction``'s set of argument keys
  (``serve/fit_engine.py``, whose steps the fleet runs too), and the one
  real compiler is ``nvcc``, run by ``kernels.build.build()``.  The
  counter observes both while a ``with`` block is active — a new step key
  as ``"step <name>"``, a library build as ``"nvcc <file>"`` — through
  the observer lists those modules keep (``fit_engine.KEY_OBSERVERS``,
  ``build.BUILD_OBSERVERS``).  ``assert_no_recompiles`` fails the block
  if any happened: the servers' *zero new keys after warmup* invariant,
  portable to any code region.
* :func:`nan_origin` — the dynamic twin of RL-DTYPE's "where did the NaN
  come from" question.  Opt-in context manager that wraps the solver
  entry points (``repro_torch.core.solve.solve`` /
  ``solve_with_fallback``) with eager finiteness checks on inputs and
  outputs, run on each tensor's own device, raising
  :class:`NaNOriginError` naming the entry point and argument the first
  moment a non-finite value crosses a solver boundary.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class CompileCounter:
    """Counts new ``StepFunction`` keys and ``nvcc`` library builds while
    active (re-entrant safe: one observer pair per instance)."""

    def __init__(self):
        self.names: list[str] = []
        self._lock = threading.Lock()

    @property
    def count(self) -> int:
        return len(self.names)

    def _record(self, name: str) -> None:
        with self._lock:       # fleet workers add keys from threads
            self.names.append(name)

    def _on_key(self, step: str, key) -> None:
        self._record(f"step {step}")

    def _on_build(self, lib) -> None:
        self._record(f"nvcc {getattr(lib, 'name', lib)}")

    def __enter__(self) -> "CompileCounter":
        from repro_torch.kernels import build
        from repro_torch.serve import fit_engine
        fit_engine.KEY_OBSERVERS.append(self._on_key)
        build.BUILD_OBSERVERS.append(self._on_build)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import build
        from repro_torch.serve import fit_engine
        fit_engine.KEY_OBSERVERS.remove(self._on_key)
        build.BUILD_OBSERVERS.remove(self._on_build)
        return None


@contextlib.contextmanager
def assert_no_recompiles(what: str = "region"):
    """Fail if any new step key or kernel build happens inside the block —
    the serve warmup invariant, portable to any code region."""
    with CompileCounter() as counter:
        yield counter
    if counter.count:
        raise AssertionError(
            f"{what}: expected zero executable compiles, got "
            f"{counter.count}: {counter.names}")


# ------------------------------------------------------------- NaN origin
class NaNOriginError(FloatingPointError):
    """A non-finite value crossed a solver entry point; ``where`` names
    the boundary, ``argument`` what carried it."""

    def __init__(self, where: str, argument: str, detail: str = ""):
        self.where = where
        self.argument = argument
        super().__init__(
            f"non-finite value at {where} ({argument})"
            + (f": {detail}" if detail else ""))


def _check_finite(where: str, argument: str, value) -> None:
    """Raise if a floating tensor or array holds a non-finite entry; a
    tensor is checked on its own device (one host read of the verdict)."""
    if isinstance(value, torch.Tensor):
        if not (value.is_floating_point() or value.is_complex()):
            return
        bad = int((~torch.isfinite(value)).sum())
        size = value.numel()
    else:
        arr = np.asarray(value)
        if arr.dtype.kind not in "fc":
            return
        bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
        size = arr.size
    if bad:
        raise NaNOriginError(where, argument,
                             f"{bad}/{size} non-finite entries")


def _wrap_entry(module, name: str, arg_names: tuple[str, ...]):
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        where = f"{module.__name__}.{name}"
        for label, val in list(zip(arg_names, args)) + list(kwargs.items()):
            if isinstance(val, (torch.Tensor, np.ndarray)):
                _check_finite(where + " input", label, val)
        out = orig(*args, **kwargs)
        for label, val in (enumerate(out) if isinstance(out, tuple)
                           else [("result", out)]):
            if isinstance(val, (torch.Tensor, np.ndarray)):
                _check_finite(where + " output",
                              f"[{label}]" if isinstance(label, int)
                              else label, val)
        return out

    wrapped.__wrapped__ = orig
    wrapped.__name__ = name
    return orig, wrapped


@contextlib.contextmanager
def nan_origin():
    """Opt-in NaN-origin mode: while active, the solver entry points
    (``repro_torch.core.solve.solve`` / ``solve_with_fallback``) check
    argument and output finiteness and raise :class:`NaNOriginError`
    naming the boundary — NaNs are caught where they enter the solve, not
    three layers later in a fit result.  Each check reads one verdict back
    from the card, so this is a debugging mode, not a serving one.

    Callers that reach the solvers through the module
    (``solve_lib.solve_with_fallback``, as the servers and fits do) see
    the wrappers; the originals are restored on exit.
    """
    from repro_torch.core import solve as solve_mod
    entries = (("solve", ("a", "b", "method")),
               ("solve_with_fallback", ("a", "b")))
    saved = []
    try:
        for name, argnames in entries:
            orig, wrapped = _wrap_entry(solve_mod, name, argnames)
            saved.append((name, orig))
            setattr(solve_mod, name, wrapped)
        yield
    finally:
        for name, orig in saved:
            setattr(solve_mod, name, orig)
