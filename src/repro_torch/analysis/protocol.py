"""RL-PROTOCOL: the fleet mailbox state machine, extracted statically
(port of ``repro.analysis.protocol``, unchanged: the port's fleet speaks
the reference's message vocabulary).

``serve/fleet.py`` speaks a closed message vocabulary — dataclasses
carrying a ``kind: str = "<name>"`` discriminator, dispatched by
``.kind ==`` comparison chains (``FleetWorker.process`` for requests,
``FitFleet._handle_replies`` for replies).  The runtime validator
(``obs.trace.validate_events``) asserts the *dynamic* consequences: every
admitted request reaches exactly one terminal instant.  This checker
asserts the same machine *statically* so the two can't drift:

* **P1 — no orphan messages**: every message class constructed somewhere
  in the module has its ``kind`` handled by some dispatcher.
* **P2 — closed-world dispatch**: a function that dispatches on ``.kind``
  must raise a typed ``ProtocolError`` for unknown kinds; a bare fallth-
  rough silently drops the message (the exact bug class the moment
  journal cannot recover from, because no timeout fires on a reply).
* **P3 — ingest acks**: every return path of the ``kind == "ingest"``
  handler carries an ``Ack`` — the journal's watermark protocol relies on
  duplicates being acked, never ignored.
* **P4 — terminal parity with the tracer**: the ``TERMINAL`` vocabulary
  declared in ``obs/trace.py`` must match the instants the fleet emits:
  every declared terminal is emitted somewhere, and every function that
  terminates a request (assigns ``.done_tick``) while tracing emits at
  least one terminal instant.  This is the static twin of
  ``validate_events``'s "exactly one terminal per admitted uid".
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.core import (Checker, FileContext, Finding,
                                       call_name, dotted_name)

def _kind_compares(fn: ast.AST):
    """Yield (Compare node, kind string) for ``<x>.kind == "const"``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 \
                or not isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
            continue
        left, right = node.left, node.comparators[0]
        if isinstance(left, ast.Constant):
            left, right = right, left
        if (isinstance(left, ast.Attribute) and left.attr == "kind"
                and isinstance(right, ast.Constant)
                and isinstance(right.value, str)
                and isinstance(node.ops[0], ast.Eq)):
            yield node, right.value


class ProtocolChecker(Checker):
    name = "protocol"
    codes = ("RL-PROTOCOL",)
    scope = ("serve/fleet.py",)

    def __init__(self, trace_path: str | Path | None = None):
        self.trace_path = Path(trace_path) if trace_path else None

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        kinds = self._message_classes(tree)          # class -> kind string
        handled = self._handled_kinds(tree)
        self._check_orphans(tree, ctx, kinds, handled, out)       # P1
        self._check_closed_dispatch(tree, ctx, out)               # P2
        self._check_ingest_acks(tree, ctx, kinds, out)            # P3
        self._check_terminals(tree, ctx, out)                     # P4
        return out

    # ---------------------------------------------------------- extraction
    def _message_classes(self, tree) -> dict[str, str]:
        kinds: dict[str, str] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id == "kind"
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    kinds[node.name] = stmt.value.value
        return kinds

    def _handled_kinds(self, tree) -> set[str]:
        return {k for _, k in _kind_compares(tree)}

    # ------------------------------------------------------------------ P1
    def _check_orphans(self, tree, ctx, kinds, handled, out):
        if not kinds:
            return
        constructed: dict[str, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                nm = call_name(node).rsplit(".", 1)[-1]
                if nm in kinds and nm not in constructed:
                    constructed[nm] = node.lineno
        for cls, line in sorted(constructed.items(), key=lambda kv: kv[1]):
            if kinds[cls] not in handled:
                out.append(Finding(
                    "RL-PROTOCOL", ctx.display_path, line,
                    f"message {cls} (kind={kinds[cls]!r}) is constructed "
                    "but no dispatcher handles that kind — it will hit "
                    "the unknown-message path on every delivery",
                    symbol=ctx.symbol_at(tree, line)))

    # ------------------------------------------------------------------ P2
    def _check_closed_dispatch(self, tree, ctx, out):
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            own = [n for n in _direct_walk(fn)]
            kinds = {k for node in own for _, k in _kind_compares_shallow(
                node)}
            if not kinds:
                continue
            if not self._raises_protocol_error(fn):
                out.append(Finding(
                    "RL-PROTOCOL", ctx.display_path, fn.lineno,
                    f"{fn.name}() dispatches on message kind "
                    f"({sorted(kinds)}) but has no ProtocolError raise "
                    "for unknown kinds — unrecognized messages are "
                    "silently dropped (no timeout fires on a reply)",
                    col=fn.col_offset, symbol=fn.name))

    @staticmethod
    def _raises_protocol_error(fn) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                nm = (call_name(exc) if isinstance(exc, ast.Call)
                      else dotted_name(exc))
                if nm.rsplit(".", 1)[-1] == "ProtocolError":
                    return True
        return False

    # ------------------------------------------------------------------ P3
    def _check_ingest_acks(self, tree, ctx, kinds, out):
        ack_classes = {c for c, k in kinds.items() if k == "ack"}
        if not ack_classes:
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.If):
                continue
            if not any(k == "ingest" for _, k in
                       _kind_compares_shallow(node.test)):
                continue
            for ret in [n for b in node.body for n in ast.walk(b)
                        if isinstance(n, ast.Return)]:
                val = ret.value
                has_ack = val is not None and any(
                    isinstance(c, ast.Call)
                    and call_name(c).rsplit(".", 1)[-1] in ack_classes
                    for c in ast.walk(val))
                if not has_ack:
                    out.append(Finding(
                        "RL-PROTOCOL", ctx.display_path, ret.lineno,
                        "ingest handler path returns without an Ack — the "
                        "journal watermark protocol requires every "
                        "delivered chunk (duplicates included) to be "
                        "acked, or retry storms never settle",
                        col=ret.col_offset,
                        symbol=ctx.symbol_at(tree, ret.lineno)))

    # ------------------------------------------------------------------ P4
    def _check_terminals(self, tree, ctx, out):
        terminals = self._load_terminals(ctx)
        if not terminals:
            return
        emitted = self._instant_names(tree)
        for t in terminals:
            if t not in emitted:
                out.append(Finding(
                    "RL-PROTOCOL", ctx.display_path, 1,
                    f"obs.trace declares terminal instant {t!r} but this "
                    "module never emits it — the static machine and "
                    "validate_events have drifted"))
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            sets_done = any(
                isinstance(n, (ast.Assign, ast.AugAssign))
                and any(isinstance(t, ast.Attribute)
                        and t.attr == "done_tick"
                        for t in (n.targets if isinstance(n, ast.Assign)
                                  else [n.target]))
                for n in ast.walk(fn))
            if not sets_done:
                continue
            names = self._instant_names(fn)
            if names and not names.intersection(terminals):
                out.append(Finding(
                    "RL-PROTOCOL", ctx.display_path, fn.lineno,
                    f"{fn.name}() terminates a request (assigns "
                    f".done_tick) and traces ({sorted(names)}) but emits "
                    f"no terminal instant from {tuple(terminals)} — "
                    "validate_events will flag every request it ends",
                    col=fn.col_offset, symbol=fn.name))

    def _load_terminals(self, ctx: FileContext) -> set[str]:
        candidates = ([self.trace_path] if self.trace_path else
                      [ctx.path.parent.parent / "obs" / "trace.py",
                       ctx.path.parent / "trace.py"])
        for cand in candidates:
            if cand is None or not cand.is_file():
                continue
            try:
                tree = ast.parse(cand.read_text())
            except SyntaxError:
                continue
            for node in tree.body:
                if (isinstance(node, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "TERMINAL"
                                for t in node.targets)
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    return {e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
        return set()

    @staticmethod
    def _instant_names(node: ast.AST) -> set[str]:
        names: set[str] = set()
        for n in ast.walk(node):
            if (isinstance(n, ast.Call)
                    and call_name(n).rsplit(".", 1)[-1] == "instant"
                    and len(n.args) >= 2
                    and isinstance(n.args[1], ast.Constant)
                    and isinstance(n.args[1].value, str)):
                names.add(n.args[1].value)
        return names


def _direct_walk(fn):
    """Nodes of ``fn`` excluding nested function/class bodies."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _kind_compares_shallow(node: ast.AST):
    """_kind_compares over a single node's subtree."""
    yield from _kind_compares(node)
