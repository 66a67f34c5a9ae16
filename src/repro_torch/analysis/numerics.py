"""RL-DTYPE and RL-VMEM: numeric-width and kernel-resource hygiene (port of
``repro.analysis.numerics``).

* **RL-DTYPE** — the moment/Gram paths are an f32 contract: every
  accumulator is f32 (compensated where it matters) and the serving stack
  round-trips snapshots through numpy.  One float64 touch silently upcasts
  the whole chain (2× memory and bytes, and a result that differs bitwise
  from the f32 kernels).  Flagged: a float64 that reaches an
  accumulation — ``dtype=torch.float64`` / ``torch.double``, ``.double()``,
  ``.to(torch.float64)``, ``torch.tensor/as_tensor/from_numpy`` of an
  explicit ``np.float64`` value without ``dtype=`` — and on the host side
  the reference's numpy spellings: explicit ``np.float64``/``np.double``,
  ``astype(float)`` / ``dtype=float`` (Python ``float`` IS f64).  A dtype
  that is a key of a dispatch table (``{torch.float64: 2}``) makes no
  value and is not flagged.  Deliberate f64 (a merge accumulating in f64
  before casting back) carries a reasoned suppression.
* **RL-VMEM** — on the card the ring kernel's budget is shared memory, not
  VMEM: ``kernels/tune.py`` models it (``ring_smem_bytes`` against
  ``SMEM_BUDGET``).  The checker recomputes that model statically: a
  literal ``block_n`` whose ring cannot fit the budget in ANY
  configuration the kernel accepts is dead-on-arrival config.  And where
  the TPU kernel had to pair each DMA's start with its wait, the CUDA
  ring pairs ``cp.async`` copies with a commit and a wait: when
  ``kernels/tune.py`` is linted, a text pass over ``csrc/*.cu`` beside it
  checks that each unit (a top-level function or struct) that issues
  ``cp_async_word`` is paired: it, or a unit that uses it, reaches
  ``cp_async_commit`` and a ``cp_async_wait*`` (an unwaited copy races
  the reads of its slot).  Those findings carry the ``.cu`` path and
  line.
"""
from __future__ import annotations

import ast
import re
from pathlib import PurePosixPath

from repro_torch.analysis.core import (Checker, FileContext, Finding,
                                       call_name, dotted_name, has_keyword,
                                       in_scope, method_name)

MOMENT_PATHS = ("core/moments.py", "core/streaming.py",
                "kernels/moments.py", "engine/plan.py", "serve/fleet.py",
                "core/distributed.py")

NP_F64 = {"np.float64", "numpy.float64", "np.double", "numpy.double"}
TORCH_F64 = {"torch.float64", "torch.double"}
TO_TENSOR = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


class DtypeChecker(Checker):
    name = "dtype"
    codes = ("RL-DTYPE",)
    scope = MOMENT_PATHS

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []

        def report(node, message):
            out.append(Finding(
                "RL-DTYPE", ctx.display_path, node.lineno, message,
                col=node.col_offset,
                symbol=ctx.symbol_at(tree, node.lineno)))

        # a dispatch table's keys name dtypes, they make no values
        keys = {id(k) for d in ast.walk(tree) if isinstance(d, ast.Dict)
                for k in d.keys if k is not None}
        # an np.float64 already reported through its torch conversion
        covered: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                self._check_call(node, report, covered)
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if isinstance(v, ast.Name) and v.id == "float":
                    report(v, "dtype=float — Python float IS float64; name "
                              "the width (np.float32) on a moment path")
                elif dotted_name(v) in TORCH_F64:
                    report(v, f"dtype={dotted_name(v)} on a moment/Gram "
                              "path — the accumulation contract is f32; an "
                              "f64 tensor silently upcasts the chain")
                    covered.add(id(v))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute) and id(node) not in keys
                    and id(node) not in covered
                    and dotted_name(node) in NP_F64):
                report(node, f"explicit {dotted_name(node)} on a moment/"
                             "Gram path — the accumulation contract is f32 "
                             "(compensated where needed); an f64 touch "
                             "silently upcasts the chain")
        return out

    @staticmethod
    def _check_call(node: ast.Call, report, covered: set[int]) -> None:
        nm = call_name(node)
        meth = method_name(node)
        if meth == "astype" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name) and a.id == "float":
                report(node, "astype(float) upcasts to float64 — name the "
                             "width (np.float32) on a moment path")
        elif meth == "double" and not node.args:
            report(node, ".double() upcasts the tensor to float64 on a "
                         "moment/Gram path — the accumulation contract is "
                         "f32")
        elif meth in ("to", "type"):
            for a in node.args:
                if dotted_name(a) in TORCH_F64:
                    report(node, f".{meth}({dotted_name(a)}) upcasts the "
                                 "tensor to float64 on a moment/Gram path "
                                 "— the accumulation contract is f32")
                    covered.add(id(a))
        elif nm in TO_TENSOR and not has_keyword(node, "dtype"):
            f64 = [a for arg in node.args for a in ast.walk(arg)
                   if isinstance(a, ast.Attribute)
                   and dotted_name(a) in NP_F64]
            if f64:
                report(node, f"{nm}() of an np.float64 value without dtype= "
                             "makes a float64 tensor on a moment/Gram path; "
                             "pass dtype=torch.float32")
                covered.update(id(a) for a in f64)


# ---------------------------------------------------------- shared memory
# Static mirror of kernels/tune.py's ring_smem_bytes.  SMEM_BUDGET, K_PAD,
# THREADS and TILE_POINTS are read from the scanned file when it defines
# them, so tune.py lints against its own constants; the fallbacks below
# match the committed model.
SMEM_BUDGET_DEFAULT = 232_448
K_PAD_DEFAULT = 128
THREADS_DEFAULT = 256
TILE_POINTS_DEFAULT = 16
NBUF_MIN = 2
# the narrowest x/y the ring streams (bfloat16) and accumulation (float32)
ITEMSIZE_MIN = 2
ACCUM_ITEMSIZE_MIN = 4


def _slot_bytes(block_n: int, itemsize: int) -> int:
    word = max(itemsize, 4)
    return -(-(block_n * itemsize + word) // 16) * 16


def min_ring_smem_bytes(block_n: int, *, k_pad: int = K_PAD_DEFAULT,
                        threads: int = THREADS_DEFAULT,
                        tile_points: int = TILE_POINTS_DEFAULT) -> int:
    """The ring kernel's shared memory at tile width ``block_n`` in its
    MOST favourable configuration: two slots, no weights, bfloat16 x and
    y, and the cheaper of its two paths (a warp's task each, so
    ``threads / 32`` rings, up to degree 14; one ring and the static tile
    above).  A lower bound over every (degree, dtype, nbuf, weighted)
    configuration: a ``block_n`` whose bound exceeds the budget fits none."""
    ring = NBUF_MIN * 2 * _slot_bytes(block_n, ITEMSIZE_MIN)
    max_powers = 2 * (k_pad - 2) + 1
    tile = (tile_points * (max_powers + 1) + tile_points) \
        * ACCUM_ITEMSIZE_MIN
    return min((threads // 32) * ring, ring + tile)


class VmemChecker(Checker):
    name = "vmem"
    codes = ("RL-VMEM",)
    scope = ("kernels/moments.py", "kernels/tune.py")

    def check(self, tree: ast.Module, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        consts = self._model_constants(tree)
        self._check_block_literals(tree, ctx, consts, out)
        if in_scope(ctx.display_path, "kernels/tune.py"):
            csrc = ctx.path.parent / "csrc"
            shown = PurePosixPath(ctx.display_path).parent / "csrc"
            for cu in sorted(csrc.glob("*.cu")):
                out.extend(check_cp_async_pairing(cu.read_text(),
                                                  str(shown / cu.name)))
        return out

    @staticmethod
    def _model_constants(tree) -> dict[str, int]:
        consts = {"SMEM_BUDGET": SMEM_BUDGET_DEFAULT, "K_PAD": K_PAD_DEFAULT,
                  "THREADS": THREADS_DEFAULT,
                  "TILE_POINTS": TILE_POINTS_DEFAULT}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in consts:
                try:
                    val = ast.literal_eval(node.value)
                except ValueError:
                    continue
                if isinstance(val, int):
                    consts[node.targets[0].id] = val
        return consts

    def _check_block_literals(self, tree, ctx, consts, out):
        sites: list[tuple[int, int, int, str]] = []   # (line, col, bn, how)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Name)
                            and "block_n" in tgt.id.lower()
                            and isinstance(node.value, ast.Constant)
                            and isinstance(node.value.value, int)):
                        sites.append((node.lineno, node.col_offset,
                                      node.value.value, tgt.id))
            elif isinstance(node, ast.keyword):
                if (node.arg == "block_n"
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, int)):
                    sites.append((node.value.lineno, node.value.col_offset,
                                  node.value.value, "block_n="))
        budget = consts["SMEM_BUDGET"]
        for line, col, bn, how in sites:
            need = min_ring_smem_bytes(bn, k_pad=consts["K_PAD"],
                                       threads=consts["THREADS"],
                                       tile_points=consts["TILE_POINTS"])
            if need > budget:
                out.append(Finding(
                    "RL-VMEM", ctx.display_path, line,
                    f"{how} {bn}: the ring needs >= {need} bytes of shared "
                    "memory even in its most favourable configuration, "
                    f"over the {budget}-byte budget for every "
                    "configuration",
                    col=col, symbol=ctx.symbol_at(tree, line)))


# ------------------------------------------------------- cp.async pairing
_PRIMITIVES = {"issue": re.compile(r"\bcp_async_word\b"),
               "commit": re.compile(r"\bcp_async_commit\b"),
               "wait": re.compile(r"\bcp_async_wait\w*\b")}
_NOISE_RE = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"'
                       r"|'(?:\\.|[^'\\\n])*'", re.S)
_TEMPLATE_RE = re.compile(r"\btemplate\s*<[^<>]*(?:<[^<>]*>[^<>]*)*>")
_ATTRIBUTE_RE = re.compile(r"\b__launch_bounds__\s*\([^()]*\)")
_TRANSPARENT_RE = re.compile(
    r'(?:\bnamespace\b[\w\s:]*|\bextern\s*"[^"\n]*")\s*$')


def _blank(m: re.Match) -> str:
    """Comments and literals to spaces (strings keep their quotes), line
    breaks kept, so offsets still give line numbers."""
    s = m.group(0)
    body = re.sub(r"[^\n]", " ", s)
    return s[0] + body[1:-1] + s[-1] if s[0] in "\"'" else body


def cu_units(text: str) -> list[tuple[str, int, str]]:
    """(name, line, body) of each top-level function or struct of a CUDA
    source; namespace and ``extern "C"`` blocks are looked through."""
    src = _NOISE_RE.sub(_blank, text)
    units: list[tuple[str, int, str]] = []
    kinds: list[str] = []          # "ns" or "unit" per open brace
    head = 0                       # where the current declaration began
    start = 0
    for i, ch in enumerate(src):
        top = "unit" not in kinds
        if ch == "{":
            if top and _TRANSPARENT_RE.search(src[head:i]):
                kinds.append("ns")
                head = i + 1
                continue
            if top:
                start = i
            kinds.append("unit")
        elif ch == "}" and kinds:
            kind = kinds.pop()
            if kind == "ns":
                head = i + 1
            elif "unit" not in kinds:
                header = _ATTRIBUTE_RE.sub(" ", _TEMPLATE_RE.sub(
                    " ", src[head:start]))
                m = (re.search(r"\b(?:struct|class|union)\s+(\w+)", header)
                     or re.search(r"(\w+)\s*\(", header))
                if m:
                    pos = head + src[head:start].find(m.group(1))
                    units.append((m.group(1), src.count("\n", 0, pos) + 1,
                                  src[start:i + 1]))
                head = i + 1
        elif ch == ";" and top:
            head = i + 1
    return units


def check_cp_async_pairing(text: str, display: str) -> list[Finding]:
    """RL-VMEM findings for one CUDA source.  A unit reaches what its body
    names and what the units it names reach.  Every unit that issues
    ``cp_async_word`` itself must be paired: it, or a unit that uses it
    (directly or through others), reaches ``cp_async_commit`` and a
    ``cp_async_wait*``.  A struct is one unit, as a loads policy commits
    in one method and waits in another; the primitives' own definitions
    are not units."""
    units = [u for u in cu_units(text) if not u[0].startswith("cp_async_")]
    names = [n for n, _, _ in units]
    refs = {n: {w for w in re.findall(r"\b\w+\b", body)
                if w in names and w != n} for n, _, body in units}
    direct = {n: {p for p, rx in _PRIMITIVES.items() if rx.search(body)}
              for n, _, body in units}
    reach = _closure(names, refs, direct)
    users = _closure(names, {n: {u for u in names if n in refs[u]}
                             for n in names},
                     {n: {n} for n in names})
    out: list[Finding] = []
    for n, line, _ in units:
        if "issue" not in direct[n]:
            continue
        for need, what in (("commit", "cp_async_commit"),
                           ("wait", "cp_async_wait*")):
            if not any(need in reach[u] for u in users[n]):
                out.append(Finding(
                    "RL-VMEM", display, line,
                    f"{n} issues cp.async copies (cp_async_word) but "
                    f"neither it nor a unit that uses it reaches {what} — "
                    + ("an uncommitted copy group is never waited on"
                       if need == "commit" else
                       "an unwaited copy races the reads of its slot"),
                    symbol=n))
    return out


def _closure(names, edges: dict, seed: dict) -> dict:
    """Each name's ``seed`` set joined with those of every name reachable
    over ``edges``."""
    out = {n: set(seed[n]) for n in names}
    changed = True
    while changed:
        changed = False
        for n in names:
            new = out[n].union(*(out[e] for e in edges[n]))
            if new != out[n]:
                out[n], changed = new, True
    return out
