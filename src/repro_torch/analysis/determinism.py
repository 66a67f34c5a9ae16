"""RL-DETERMINISM: the virtual-tick replay domain must stay replayable
(port of ``repro.analysis.determinism``).

``serve/fleet.py``, ``runtime/chaos.py``, ``obs/trace.py`` and
``core/distributed.py`` share a committed contract: same seed + same chaos
schedule → byte-identical event logs and bit-identical coefficients.  Any
dependence on ambient nondeterminism breaks that silently.  Four families
are statically visible:

* **wall clock** — ``time.time()`` / ``datetime.now()`` and friends inside
  the tick domain (time here is an *injected* tick counter);
* **unseeded numpy or stdlib RNG** — ``np.random.default_rng()`` with no
  seed, the global ``np.random.*`` functions, or the stdlib ``random``
  module;
* **torch's global RNG** — ``torch.manual_seed`` /
  ``torch.cuda.manual_seed*`` (reseeding a stream every other caller
  shares), and the samplers ``torch.rand/randn/randint/randperm/normal/
  bernoulli/multinomial`` without ``generator=``: the port's rule is an
  explicit ``torch.Generator`` per consumer, so one call site's draws
  cannot shift another's;
* **set-iteration order** — iterating a set expression directly: Python
  set order is hash-seed dependent, so any per-element side effect lands
  in a different order per process.  Wrap in ``sorted(...)`` to fix.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Checker, FileContext, Finding,
                                       call_name, has_keyword)

TICK_DOMAIN = ("serve/fleet.py", "runtime/chaos.py", "obs/trace.py",
               "core/distributed.py")

WALL_CLOCK = {"time.time", "time.time_ns", "time.monotonic",
              "time.monotonic_ns", "time.perf_counter",
              "time.perf_counter_ns", "time.process_time"}
# matched on the trailing two segments, so datetime.datetime.now() and
# dt.now() both hit
WALL_CLOCK_TAILS = {"datetime.now", "datetime.utcnow", "datetime.today",
                    "date.today"}
# np.random attributes that are fine: explicitly seeded constructors
SEEDED_RNG_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                    "Philox"}
SET_METHODS = {"union", "intersection", "difference",
               "symmetric_difference"}
# torch calls that reseed the process-wide streams
TORCH_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                      "torch.cuda.seed", "torch.cuda.seed_all",
                      "torch.random.manual_seed", "torch.random.seed"}
# torch samplers that draw from the global stream unless given generator=
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                  "bernoulli", "multinomial"}


class DeterminismChecker(Checker):
    name = "determinism"
    codes = ("RL-DETERMINISM",)
    scope = TICK_DOMAIN

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(node, tree, ctx, out)
            elif isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                bad = _set_expr(it)
                if bad:
                    out.append(Finding(
                        "RL-DETERMINISM", ctx.display_path, it.lineno,
                        f"iteration over a set expression ({bad}) — order "
                        "is hash-seed dependent, so per-element effects "
                        "replay differently; iterate sorted(...) instead",
                        col=it.col_offset,
                        symbol=ctx.symbol_at(tree, it.lineno)))
        return out

    def _check_call(self, node: ast.Call, tree, ctx, out):
        nm = call_name(node)

        def report(message):
            out.append(Finding(
                "RL-DETERMINISM", ctx.display_path, node.lineno, message,
                col=node.col_offset,
                symbol=ctx.symbol_at(tree, node.lineno)))

        tail2 = ".".join(nm.split(".")[-2:])
        if nm in WALL_CLOCK or tail2 in WALL_CLOCK_TAILS \
                or tail2 in WALL_CLOCK:
            report(f"wall-clock read {nm}() inside the virtual-tick domain "
                   "— time here is the injected tick counter; thread it in")
            return
        parts = nm.split(".")
        if parts[0] == "torch":
            if nm in TORCH_GLOBAL_SEEDS:
                report(f"{nm}() reseeds torch's process-wide stream — every "
                       "other consumer's draws shift; give this one a "
                       "torch.Generator(...).manual_seed(seed)")
            elif (len(parts) == 2 and parts[1] in TORCH_SAMPLERS
                  and not has_keyword(node, "generator")):
                report(f"{nm}() without generator= draws from torch's global "
                       "stream — order-dependent across call sites; pass an "
                       "explicit seeded torch.Generator")
            return
        if "random" in parts[:-1]:           # np.random.X / numpy.random.X
            fn = parts[-1]
            if fn in SEEDED_RNG_CTORS:
                if not node.args and not node.keywords:
                    report(f"{nm}() with no seed — entropy from the OS makes "
                           "the replay contract unsatisfiable; pass a seed")
            else:
                report(f"{nm}() uses the global RNG stream — order-dependent "
                       "across call sites and unseeded by default; use a "
                       "seeded np.random.default_rng(seed)")
        elif parts[0] == "random" and len(parts) == 2:
            report(f"stdlib {nm}() draws from the process-global RNG — "
                   "seedless under pytest-randomization; use a seeded "
                   "generator")


def _set_expr(node: ast.AST) -> str:
    """Describe ``node`` if it syntactically produces a set, else ""."""
    if isinstance(node, ast.Set):
        return "set literal"
    if isinstance(node, ast.SetComp):
        return "set comprehension"
    if isinstance(node, ast.Call):
        nm = call_name(node)
        if nm in ("set", "frozenset"):
            return f"{nm}() call"
        if nm.rsplit(".", 1)[-1] in SET_METHODS:
            return f".{nm.rsplit('.', 1)[-1]}() result"
    return ""
