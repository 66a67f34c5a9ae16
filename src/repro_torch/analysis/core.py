"""reprolint core for the PyTorch port: findings, suppressions, the checker
registry, the runner (port of ``repro.analysis.core``).

The port's invariants are the reference's, held by other means: zero new
step keys after a fit server's warmup (where the reference counts jit
compiles), bit-identical chaos replays, span-chain validation, an f32
moment contract, and kernels that fit the card's shared memory.
``repro_torch.analysis`` checks them at review time, one AST pass per
invariant family, each finding carrying a stable code (RL-*), runnable as
``python -m repro_torch.analysis`` over the port's files.

Vocabulary
----------
* A **checker** subclasses :class:`Checker`, declares its ``codes`` and an
  optional ``scope`` (path suffixes it applies to; ``None`` = every file),
  and emits :class:`Finding`s from ``check(tree, ctx)``.
* A **finding** is one (code, path, line) diagnostic.  Findings on a line
  carrying ``# reprolint: disable=CODE — reason`` are recorded as
  suppressed, not dropped: the JSON report keeps the audit trail, and a
  disable comment WITHOUT a reason is itself a finding (RL-SUPPRESS).
* The **runner** (:func:`run_lint`) walks the target files, parses each
  once, fans the AST to every in-scope checker, applies suppressions, and
  returns a :class:`Report` (schema version 1, field for field the
  reference's, so either package loads the other's report).

The comment spelling and the seven codes are the reference's: the JAX
package's linter reads the port's files too, and reports a code it does
not know as RL-SUPPRESS.  Scoped checkers match by path suffix, so the
fixture corpus opts in by naming its files ``<anything>__<suffix>`` — see
``fixture_scope_path``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import tokenize
from pathlib import Path

SCHEMA_VERSION = 1

# the finding vocabulary: the reference's seven codes, with the port's
# meanings
CODE_SUPPRESS = "RL-SUPPRESS"
ALL_CODES: dict[str, str] = {
    "RL-RECOMPILE": "step-key hazard (a per-call Python scalar keys a "
                    "StepFunction, mutable dataclass defaults, f-string "
                    "or id() cache keys)",
    "RL-TRACERLEAK": "host sync (.item(), .cpu(), float() of a tensor, "
                     "branching on one) in code reachable from a "
                     "StepFunction or an autograd.Function",
    "RL-DETERMINISM": "wall clock, unseeded or global RNG (numpy, stdlib "
                      "or torch), or set-iteration order inside the "
                      "virtual-tick replay domain",
    "RL-PROTOCOL": "fleet mailbox state machine incomplete or drifted from "
                   "obs.trace.validate_events",
    "RL-DTYPE": "silent f32->f64 promotion hazard on a moment/Gram path",
    "RL-VMEM": "ring kernel block exceeds the shared-memory model, or a "
               "cp.async copy never committed or waited",
    CODE_SUPPRESS: "malformed suppression (disable comment without a "
                   "reason, or naming an unknown code)",
}

# spelling of a suppression comment: the marker, one or more codes after
# the equals sign, then a dash-separated reason
_DISABLE_RE = re.compile(
    r"#\s*reprolint:\s*disable=(?P<codes>[A-Z0-9,\-\s]+?)"
    r"(?:\s+(?:—|--|-)\s*(?P<reason>.+?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a stable code, a location, and the claim."""

    code: str
    path: str
    line: int
    message: str
    col: int = 0
    symbol: str = ""            # enclosing function/class, when known
    suppressed: bool = False
    suppression_reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Finding":
        return Finding(**d)

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        sup = (f"  (suppressed: {self.suppression_reason})"
               if self.suppressed else "")
        return (f"{self.path}:{self.line}:{self.col}: {self.code}{sym} "
                f"{self.message}{sup}")


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    codes: tuple[str, ...]
    reason: str
    standalone: bool     # comment-only line: applies to the NEXT code line


@dataclasses.dataclass
class FileContext:
    """Everything a checker gets besides the AST."""

    path: Path
    display_path: str
    source: str
    lines: list[str]

    def symbol_at(self, tree: ast.AST, line: int) -> str:
        """Innermost def/class enclosing ``line`` (best-effort)."""
        best = ""
        best_span = None
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                end = getattr(node, "end_lineno", node.lineno)
                if node.lineno <= line <= end:
                    span = end - node.lineno
                    if best_span is None or span <= best_span:
                        best, best_span = node.name, span
        return best


class Checker:
    """Base class: subclass, set ``name``/``codes``/``scope``, implement
    ``check``.  ``scope`` is a tuple of path suffixes (posix, e.g.
    ``"serve/fleet.py"``); ``None`` means every Python file."""

    name: str = ""
    codes: tuple[str, ...] = ()
    scope: tuple[str, ...] | None = None

    def applies_to(self, display_path: str) -> bool:
        if self.scope is None:
            return True
        return any(in_scope(display_path, sfx) for sfx in self.scope)

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        raise NotImplementedError


def in_scope(display_path: str, suffix: str) -> bool:
    """``display_path`` ends with ``suffix``, or is a fixture that opts in
    to it by name."""
    p = display_path.replace("\\", "/")
    return p.endswith(suffix) or _fixture_matches(p, suffix)


def _fixture_matches(path: str, suffix: str) -> bool:
    """Fixture files opt into a scoped checker by embedding the scope
    suffix with ``/`` spelled ``__``: ``bad__serve__fleet.py`` runs the
    checkers scoped to ``serve/fleet.py``."""
    name = path.rsplit("/", 1)[-1]
    mangled = suffix.replace("/", "__").removesuffix(".py")
    return mangled in name


def fixture_scope_path(suffix: str, kind: str) -> str:
    """The fixture-corpus filename that opts into scope ``suffix``:
    ``fixture_scope_path("serve/fleet.py", "bad") ==
    "bad__serve__fleet.py"``."""
    return f"{kind}__{suffix.replace('/', '__')}"


# ----------------------------------------------------------- suppressions
def collect_suppressions(ctx: FileContext) -> tuple[list[Suppression],
                                                    list[Finding]]:
    """Parse every ``# reprolint: disable=...`` comment.  A disable with no
    reason, or naming a code the suite does not define, is itself a
    finding (the suppression policy is enforced by the tool)."""
    sups: list[Suppression] = []
    probs: list[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(
            iter(ctx.source.splitlines(keepends=True)).__next__))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sups, probs
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _DISABLE_RE.search(tok.string)
        if m is None:
            if "reprolint" in tok.string and "disable" in tok.string:
                probs.append(Finding(
                    CODE_SUPPRESS, ctx.display_path, tok.start[0],
                    f"unparseable reprolint comment {tok.string.strip()!r} "
                    "(spelling: `# reprolint: disable=CODE — reason`)"))
            continue
        codes = tuple(c.strip() for c in m.group("codes").split(",")
                      if c.strip())
        reason = (m.group("reason") or "").strip()
        line = tok.start[0]
        standalone = ctx.lines[line - 1].lstrip().startswith("#")
        unknown = [c for c in codes if c not in ALL_CODES]
        if unknown:
            probs.append(Finding(
                CODE_SUPPRESS, ctx.display_path, line,
                f"disable names unknown code(s) {unknown} (known: "
                f"{sorted(ALL_CODES)})"))
        if not reason:
            probs.append(Finding(
                CODE_SUPPRESS, ctx.display_path, line,
                "suppression without a reason — spell it `# reprolint: "
                "disable=CODE — why this is deliberate`"))
            continue          # a reasonless disable does not suppress
        sups.append(Suppression(line, codes, reason, standalone))
    return sups, probs


def apply_suppressions(findings: list[Finding],
                       sups: list[Suppression]) -> list[Finding]:
    """Mark findings covered by a disable comment.  Inline comments cover
    their own line; standalone comment lines cover the next line."""
    by_line: dict[int, Suppression] = {}
    for s in sups:
        by_line[s.line + 1 if s.standalone else s.line] = s
    out = []
    for f in findings:
        s = by_line.get(f.line)
        if s is not None and f.code in s.codes:
            f = dataclasses.replace(f, suppressed=True,
                                    suppression_reason=s.reason)
        out.append(f)
    return out


# ----------------------------------------------------------------- runner
def default_checkers() -> list[Checker]:
    from repro_torch.analysis import (determinism, jit_hazards, numerics,
                                      protocol)
    return [
        jit_hazards.RecompileChecker(),
        jit_hazards.TracerLeakChecker(),
        determinism.DeterminismChecker(),
        protocol.ProtocolChecker(),
        numerics.DtypeChecker(),
        numerics.VmemChecker(),
    ]


# the port's files, relative to the checkout's root (a pattern is globbed
# there); the JAX package's linter keeps covering its own trees
DEFAULT_ROOTS = ("src/repro_torch", "examples/torch_*.py", "chip_smoke.py")
_SKIP_PARTS = {"fixtures", "__pycache__", ".git"}


def default_roots(base: str | Path = ".") -> list[Path]:
    """``DEFAULT_ROOTS`` that exist under ``base``, patterns expanded."""
    base = Path(base)
    out: list[Path] = []
    for r in DEFAULT_ROOTS:
        if any(c in r for c in "*?["):
            out.extend(sorted(base.glob(r)))
        elif (base / r).exists():
            out.append(base / r)
    return out


def discover_files(roots: list[str | Path]) -> list[Path]:
    files: list[Path] = []
    for root in roots:
        root = Path(root)
        if root.is_file():
            files.append(root)
            continue
        for p in sorted(root.rglob("*.py")):
            if _SKIP_PARTS.intersection(p.parts):
                continue
            files.append(p)
    return files


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    files_scanned: int

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    def counts(self, suppressed: bool | None = None) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            if suppressed is not None and f.suppressed != suppressed:
                continue
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {"version": SCHEMA_VERSION,
                "files_scanned": self.files_scanned,
                "counts": self.counts(),
                "counts_unsuppressed": self.counts(suppressed=False),
                "findings": [f.to_dict() for f in self.findings]}

    @staticmethod
    def from_dict(d: dict) -> "Report":
        if d.get("version") != SCHEMA_VERSION:
            raise ValueError(f"unknown report version {d.get('version')!r}")
        return Report([Finding.from_dict(f) for f in d["findings"]],
                      d["files_scanned"])

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def render_human(self) -> str:
        lines = [f.render() for f in self.findings]
        live = len(self.unsuppressed)
        supp = len(self.findings) - live
        lines.append(f"reprolint: {self.files_scanned} files, "
                     f"{live} finding(s), {supp} suppressed")
        return "\n".join(lines)


def lint_file(path: str | Path, checkers: list[Checker] | None = None,
              display_path: str | None = None,
              select: tuple[str, ...] | None = None) -> list[Finding]:
    """Run the (in-scope) checkers over one file; suppressions applied.
    A checker may also report on a file beside it (RL-VMEM's cp.async pass
    over ``csrc/*.cu``); a disable comment covers only the linted file."""
    path = Path(path)
    source = path.read_text()
    display = display_path or _display(path)
    ctx = FileContext(path=path, display_path=display, source=source,
                      lines=source.splitlines())
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(CODE_SUPPRESS, display, e.lineno or 1,
                        f"file does not parse: {e.msg}")]
    sups, problems = collect_suppressions(ctx)
    findings = list(problems)
    for ch in (checkers if checkers is not None else default_checkers()):
        if not ch.applies_to(display):
            continue
        if select and not any(c in select for c in ch.codes):
            continue
        findings.extend(ch.check(tree, ctx))
    if select:
        findings = [f for f in findings
                    if f.code in select or f.code == CODE_SUPPRESS]
    own = sorted((f for f in findings if f.path == display),
                 key=lambda f: (f.line, f.col, f.code))
    beside = sorted((f for f in findings if f.path != display),
                    key=lambda f: (f.path, f.line, f.col, f.code))
    return apply_suppressions(own, sups) + beside


def _display(path: Path) -> str:
    try:
        return path.resolve().relative_to(Path.cwd().resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def run_lint(roots: list[str | Path] | None = None,
             checkers: list[Checker] | None = None,
             select: tuple[str, ...] | None = None) -> Report:
    """Lint every Python file under ``roots`` (default: the port's files,
    ``DEFAULT_ROOTS`` relative to cwd)."""
    roots = list(roots) if roots else default_roots()
    checkers = checkers if checkers is not None else default_checkers()
    files = discover_files(roots)
    findings: list[Finding] = []
    for f in files:
        findings.extend(lint_file(f, checkers, select=select))
    return Report(findings, files_scanned=len(files))


# -------------------------------------------------------- shared AST utils
def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, else ""."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)


def method_name(node: ast.Call) -> str:
    """The called attribute of ``<any expression>.name(...)``, else ""."""
    return node.func.attr if isinstance(node.func, ast.Attribute) else ""


def has_keyword(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)
