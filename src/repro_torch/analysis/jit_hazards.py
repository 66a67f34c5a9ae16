"""RL-RECOMPILE and RL-TRACERLEAK: the step-key and host-sync passes (port
of ``repro.analysis.jit_hazards``).

The fit servers' headline invariant is *zero new step keys across request
churn*: each ``StepFunction`` (``serve/fit_engine.py``) remembers the
argument signatures it has run under (the key the reference's jit cache
uses), warmup fills a fixed set, and every later step reuses it.  The
port has no compiler, so the hazards are the key's and the host's:

* **RL-RECOMPILE** — something per-call reaches a key: ``_signature``
  keys a bare Python number or string by its VALUE, so a step call that
  passes one computed per call (``int(n)``, ``float(scale)``,
  ``len(xs)``, an f-string, ``.item()``) mints a new key on each new
  value — a literal or a spec dataclass does not.  Carried over from the
  reference: a mutable default on a dataclass that rides into specs
  (shared state AND an unhashable key), and an f-string or
  ``id()``-derived key in a cache dict.
* **RL-TRACERLEAK** — a host sync inside code reachable from a
  ``StepFunction``'s function or from an ``autograd.Function``'s
  ``forward``/``backward``: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``float()``/``int()``/``bool()`` of a tensor expression,
  ``if``/``while`` (or a conditional expression or ``assert``) on a
  ``torch.*`` expression, or ``print`` of a value.  Each waits for the
  card once per step where the step was meant to queue work and return.

Reachability is per-module, as in the reference: roots are the functions
passed (possibly through ``functools.partial``) to ``StepFunction(...)``
and the ``forward``/``backward`` methods of ``autograd.Function``
subclasses; the call graph is then closed over bare-name calls within the
module.  The port uses no ``torch.compile``: there is no graph to break.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Checker, FileContext, Finding,
                                       call_name, dotted_name, method_name)

MUTABLE_CALLS = {"list", "dict", "set", "bytearray"}
# the port's step factories in other modules (serve/fit_engine.py), whose
# results the fleet holds; factories of the linted module are found by
# their ``return StepFunction(...)``
STEP_FACTORIES = {"make_spec_solve", "make_spec_sweep"}
# Python scalars computed per call: each value is a new step key
SCALAR_CALLS = {"int", "float", "str", "len", "round", "bool", "abs",
                "hash"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch.* calls that return static Python values — safe in `if` tests
STATIC_SAFE_TORCH = {"finfo", "iinfo", "is_tensor", "is_floating_point",
                     "is_complex", "is_storage", "device", "Size",
                     "get_default_dtype", "is_grad_enabled",
                     "is_inference_mode_enabled", "result_type",
                     "promote_types", "can_cast", "numel", "dtype"}
# torch namespaces whose calls ask the runtime, not a tensor
STATIC_SAFE_TORCH_NS = {"cuda", "distributed", "backends", "version",
                        "jit", "compiler", "accelerator"}


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and call_name(node) in MUTABLE_CALLS:
        return True
    return False


def _is_step_ctor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and call_name(node).split(".")[-1] == "StepFunction")


class RecompileChecker(Checker):
    name = "recompile"
    codes = ("RL-RECOMPILE",)
    scope = None

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        self._check_dataclasses(tree, ctx, out)
        self._check_step_calls(tree, ctx, out)
        self._check_cache_keys(tree, ctx, out)
        return out

    # -- mutable defaults on (FitSpec-adjacent) dataclasses ---------------
    def _check_dataclasses(self, tree, ctx, out):
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            is_dc = any(n and n.split(".")[-1] == "dataclass"
                        for _, n in _class_decorators(node))
            if not is_dc:
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    default = stmt.value
                    if (isinstance(default, ast.Call)
                            and call_name(default).split(".")[-1] == "field"):
                        default = next(
                            (kw.value for kw in default.keywords
                             if kw.arg == "default"), None)
                    if default is not None and _is_mutable_literal(default):
                        tgt = getattr(stmt.target, "id", "?")
                        out.append(Finding(
                            "RL-RECOMPILE", ctx.display_path, stmt.lineno,
                            f"dataclass field {tgt!r} has a mutable default "
                            "— shared across instances, and unhashable if "
                            "the class ever rides a step key; use "
                            "field(default_factory=...)",
                            col=stmt.col_offset, symbol=node.name))

    # -- per-call scalars reaching a StepFunction's key -------------------
    def _check_step_calls(self, tree, ctx, out):
        factories = set(STEP_FACTORIES)
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(isinstance(r, ast.Return) and _is_step_ctor(r.value)
                            for r in ast.walk(fn)):
                factories.add(fn.name)
        names: set[str] = set()      # bare names bound to a step
        attrs: set[str] = set()      # attributes (self.X) bound to a step
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = call_name(node.value).split(".")[-1]
            if callee != "StepFunction" and callee not in factories:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
                elif isinstance(tgt, ast.Attribute):
                    attrs.add(tgt.attr)
        if not (names or attrs):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not ((isinstance(f, ast.Name) and f.id in names)
                    or (isinstance(f, ast.Attribute) and f.attr in attrs)):
                continue
            step = dotted_name(f) or getattr(f, "attr", "?")
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                what = _per_call_scalar(arg)
                if what:
                    out.append(Finding(
                        "RL-RECOMPILE", ctx.display_path, arg.lineno,
                        f"{what} passed to StepFunction {step}() — it keys "
                        "a Python scalar by its value, so every new value "
                        "mints a new step key; pass it as a tensor or fix "
                        "it in the spec",
                        col=arg.col_offset,
                        symbol=ctx.symbol_at(tree, node.lineno)))

    # -- cache key hygiene ------------------------------------------------
    def _check_cache_keys(self, tree, ctx, out):
        for node in ast.walk(tree):
            key = None
            if isinstance(node, ast.Subscript) \
                    and _is_cache_name(dotted_name(node.value)):
                key = node.slice
            elif isinstance(node, ast.Call):
                nm = call_name(node)
                if (nm.endswith((".get", ".setdefault", ".pop"))
                        and _is_cache_name(nm.rsplit(".", 1)[0])
                        and node.args):
                    key = node.args[0]
            if key is None:
                continue
            for bad in ast.walk(key):
                if isinstance(bad, ast.JoinedStr):
                    out.append(Finding(
                        "RL-RECOMPILE", ctx.display_path, bad.lineno,
                        "f-string used as a cache key — embeds reprs that "
                        "differ across processes/objects; key on a tuple "
                        "of hashable statics instead",
                        col=bad.col_offset,
                        symbol=ctx.symbol_at(tree, bad.lineno)))
                    break
                if isinstance(bad, ast.Call) and call_name(bad) == "id":
                    out.append(Finding(
                        "RL-RECOMPILE", ctx.display_path, bad.lineno,
                        "id() used in a cache key — object identity is not "
                        "stable across runs (or after GC reuse); key on "
                        "value equality instead",
                        col=bad.col_offset,
                        symbol=ctx.symbol_at(tree, bad.lineno)))
                    break
                if _is_mutable_literal(bad):
                    out.append(Finding(
                        "RL-RECOMPILE", ctx.display_path, bad.lineno,
                        "mutable (unhashable) cache key",
                        col=bad.col_offset,
                        symbol=ctx.symbol_at(tree, bad.lineno)))
                    break


def _per_call_scalar(node: ast.AST) -> str:
    """Describe ``node`` if it computes a Python scalar at the call, else
    "" (a literal, a name or a spec is not flagged)."""
    if isinstance(node, ast.JoinedStr):
        return "an f-string"
    if isinstance(node, ast.Call):
        nm = call_name(node)
        if nm in SCALAR_CALLS:
            return f"{nm}(...)"
        if method_name(node) == "item" and not node.args:
            return ".item()"
        return ""
    if isinstance(node, ast.BinOp):
        return _per_call_scalar(node.left) or _per_call_scalar(node.right)
    if isinstance(node, ast.UnaryOp):
        return _per_call_scalar(node.operand)
    return ""


def _is_cache_name(name: str) -> bool:
    return "cache" in name.rsplit(".", 1)[-1].lower()


def _class_decorators(node: ast.ClassDef):
    for dec in node.decorator_list:
        yield dec, (call_name(dec) if isinstance(dec, ast.Call)
                    else dotted_name(dec))


# -------------------------------------------------------------- host syncs
class TracerLeakChecker(Checker):
    name = "tracerleak"
    codes = ("RL-TRACERLEAK",)
    scope = None

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        # bare-name call targets: functions, not methods
        methods = {id(s) for c in ast.walk(tree) if isinstance(c, ast.ClassDef)
                   for s in c.body}
        funcs = {n.name: n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and id(n) not in methods}
        roots = self._step_roots(tree, funcs)
        for fn in self._close_reachable(roots, funcs):
            self._check_syncs(fn, ctx, out)
        out.sort(key=lambda f: (f.line, f.col))
        return out

    @staticmethod
    def _step_roots(tree, funcs: dict) -> list:
        roots = []
        for node in ast.walk(tree):
            if _is_step_ctor(node) and node.args:
                roots.extend(funcs[n] for n in
                             sorted(_referenced_fn_names(node.args[0]))
                             if n in funcs)
            elif isinstance(node, ast.ClassDef) and any(
                    dotted_name(b) in ("Function", "autograd.Function",
                                       "torch.autograd.Function")
                    for b in node.bases):
                roots.extend(s for s in node.body
                             if isinstance(s, (ast.FunctionDef,
                                               ast.AsyncFunctionDef))
                             and s.name in ("forward", "backward"))
        return roots

    @staticmethod
    def _close_reachable(roots: list, funcs: dict) -> list:
        seen = {id(r): r for r in roots}
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = funcs.get(call_name(node))
                    if callee is not None and id(callee) not in seen:
                        seen[id(callee)] = callee
                        frontier.append(callee)
        return list(seen.values())

    def _check_syncs(self, fn, ctx, out):
        def report(node, message):
            out.append(Finding(
                "RL-TRACERLEAK", ctx.display_path, node.lineno,
                f"{message} inside step-reachable {fn.name}() — the host "
                "waits for the card there on every call",
                col=node.col_offset, symbol=fn.name))

        for node in ast.walk(fn):
            test, what = None, ""
            if isinstance(node, (ast.If, ast.While)):
                test = node.test
                what = "if" if isinstance(node, ast.If) else "while"
            elif isinstance(node, ast.IfExp):
                test, what = node.test, "conditional expression"
            elif isinstance(node, ast.Assert):
                test, what = node.test, "assert"
            elif isinstance(node, ast.Call):
                nm = call_name(node)
                meth = method_name(node)
                if meth in SYNC_METHODS and not node.args:
                    report(node, f"host sync .{meth}()")
                elif nm in ("bool", "float", "int") and node.args:
                    leak = _find_tensor_call(node.args[0])
                    if leak is not None:
                        report(node, f"{nm}() of tensor expression {leak!r}")
                elif nm == "print" and any(
                        not isinstance(a, ast.Constant) for a in node.args):
                    report(node, "print of a value")
                continue
            if test is None:
                continue
            leak = _find_tensor_call(test)
            if leak is not None:
                report(node, f"Python {what} on tensor expression {leak!r}")


def _referenced_fn_names(node: ast.AST) -> set[str]:
    """Function names referenced by ``node`` — a bare Name, or inside a
    ``functools.partial(...)`` first argument."""
    names: set[str] = set()
    if isinstance(node, ast.Name):
        names.add(node.id)
    elif isinstance(node, ast.Call) \
            and call_name(node).split(".")[-1] == "partial" and node.args:
        names.update(_referenced_fn_names(node.args[0]))
    return names


def _find_tensor_call(test: ast.AST) -> str | None:
    """The first ``torch.*`` (tensor-returning) call inside ``test``."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Call):
            continue
        parts = call_name(node).split(".")
        if (parts[0] == "torch" and len(parts) >= 2
                and parts[1] not in STATIC_SAFE_TORCH_NS
                and parts[-1] not in STATIC_SAFE_TORCH):
            return ".".join(parts)
    return None
