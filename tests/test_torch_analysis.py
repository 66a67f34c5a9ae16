"""The port's reprolint (``repro_torch.analysis``): fixture corpus,
suppression semantics, JSON schema, CLI, the port-cleanliness meta-test,
the runtime sanitizers, and agreement with ``repro.analysis`` on the
reference corpus whose rules carry over unchanged.

Mirrors ``tests/test_analysis.py`` case for case; the port's corpus is
``tests/fixtures/reprolint_torch``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis as ref_analysis
from repro_torch.analysis import (ALL_CODES, CODE_SUPPRESS, CompileCounter,
                                  Finding, NaNOriginError, Report,
                                  assert_no_recompiles, lint_file,
                                  nan_origin, run_lint)
from repro_torch.serve.fit_engine import (FitServeConfig, FitServeEngine,
                                          StepFunction)

REPO = Path(__file__).resolve().parent.parent
FIXDIR = REPO / "tests" / "fixtures" / "reprolint_torch"
REF_FIXDIR = REPO / "tests" / "fixtures" / "reprolint"
ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
       "HOME": os.environ.get("HOME", "/tmp")}

# (code, bad fixture, good fixture) — one pinned pair per checker code
CORPUS = [
    ("RL-RECOMPILE", "bad_recompile.py", "good_recompile.py"),
    ("RL-TRACERLEAK", "bad_tracerleak.py", "good_tracerleak.py"),
    ("RL-DETERMINISM", "bad__runtime__chaos.py", "good__runtime__chaos.py"),
    ("RL-PROTOCOL", "bad__serve__fleet.py", "good__serve__fleet.py"),
    ("RL-DTYPE", "bad__core__moments.py", "good__core__moments.py"),
    ("RL-VMEM", "vmem_bad/bad__kernels__tune.py",
     "vmem_good/good__kernels__tune.py"),
    (CODE_SUPPRESS, "bad_suppress.py", "good_suppress.py"),
]


def live(findings):
    return [f for f in findings if not f.suppressed]


# ------------------------------------------------------------ the tripwire
@pytest.fixture(autouse=True)
def _no_recompile_tripwire(request):
    """Tests marked ``no_recompile`` fail on any new step key or kernel
    build (the port's counterpart of the reference's conftest tripwire,
    armed in this file without an environment flag)."""
    if request.node.get_closest_marker("no_recompile") is None:
        yield
        return
    with CompileCounter() as counter:
        yield
    if counter.count:
        pytest.fail(f"no_recompile test compiled {counter.count} "
                    f"executable(s): {counter.names}")


# ------------------------------------------------------------------ corpus
@pytest.mark.parametrize("code,bad,good", CORPUS,
                         ids=[c for c, _, _ in CORPUS])
def test_bad_fixture_detected_and_pure(code, bad, good):
    findings = live(lint_file(FIXDIR / bad))
    codes = {f.code for f in findings}
    assert code in codes, f"{bad} produced {codes}, wanted {code}"
    # the corpus is single-voiced: a bad fixture trips ONLY its own code
    assert codes == {code}, f"{bad} leaked extra codes: {codes - {code}}"


@pytest.mark.parametrize("code,bad,good", CORPUS,
                         ids=[c for c, _, _ in CORPUS])
def test_good_fixture_is_finding_free(code, bad, good):
    findings = live(lint_file(FIXDIR / good))
    assert findings == [], [f.render() for f in findings]


def test_every_code_has_a_fixture_pair():
    assert {c for c, _, _ in CORPUS} == set(ALL_CODES)
    # the seven codes are the reference's: its linter reads the port's
    # disable comments and reports any other code as RL-SUPPRESS
    assert set(ALL_CODES) == set(ref_analysis.ALL_CODES)


def test_bad_recompile_covers_every_key_hazard():
    msgs = [f.message for f in live(lint_file(FIXDIR / "bad_recompile.py"))]
    for what in ("f-string used as a cache key", "id() used",
                 "mutable default", "float(...) passed to StepFunction",
                 "int(...) passed to StepFunction"):
        assert any(what in m for m in msgs), what


def test_bad_tracerleak_covers_every_sync_kind():
    found = live(lint_file(FIXDIR / "bad_tracerleak.py"))
    msgs = " ".join(f.message for f in found)
    for what in ("Python if", "Python while", "float() of tensor",
                 "print of a value", ".item()", ".cpu()"):
        assert what in msgs, what
    # the autograd.Function's forward is a root as a StepFunction's is
    assert "forward" in {f.symbol for f in found}


def test_bad_determinism_flags_torch_global_rng():
    msgs = [f.message for f in
            live(lint_file(FIXDIR / "bad__runtime__chaos.py"))]
    assert any(m.startswith("torch.manual_seed()") for m in msgs)
    assert any(m.startswith("torch.randn() without generator=")
               for m in msgs)
    assert any(m.startswith("torch.randint() without generator=")
               for m in msgs)


def test_dtype_dispatch_table_key_is_not_flagged(tmp_path):
    p = tmp_path / "x__kernels__moments.py"
    p.write_text("import torch\n"
                 "_ACC = {torch.float32: 0, torch.float64: 1}\n"
                 "y = torch.zeros(3, dtype=torch.float64)\n")
    assert [(f.code, f.line) for f in lint_file(p)] == [("RL-DTYPE", 3)]


def test_vmem_flags_the_cu_file_at_its_line():
    found = live(lint_file(FIXDIR / "vmem_bad" / "bad__kernels__tune.py"))
    cu = [f for f in found if f.path.endswith("csrc/ring.cu")]
    assert [(f.line, f.symbol) for f in cu] == [(17, "LeakyRing")]
    assert "cp_async_wait" in cu[0].message
    # a literal block only the smallest configuration could hold is fine
    # (block_n=2048 fits the ring above degree 14); 65536 fits none
    lits = sorted(f.line for f in found if f not in cu)
    assert lits == [6, 10]


def test_vmem_smem_mirror_matches_tune():
    from repro_torch.analysis import numerics
    from repro_torch.kernels import tune
    for bn in tune.CANDIDATE_BLOCKS + (4096, 16384):
        configs = [tune.ring_smem_bytes(d, bn, nbuf=nbuf, itemsize=it,
                                        weighted=wt)
                   for d in (1, 14, 15, 126) for nbuf in (2, 3, 4)
                   for it in (2, 4, 8) for wt in (False, True)]
        assert numerics.min_ring_smem_bytes(bn) == min(configs)
    assert numerics.SMEM_BUDGET_DEFAULT == tune.SMEM_BUDGET


# ------------------------------------------------------------ suppressions
def test_inline_suppression_with_reason(tmp_path):
    p = tmp_path / "bad__core__moments.py"
    p.write_text("import torch\n"
                 "x = torch.ones(3).double()"
                 "  # reprolint: disable=RL-DTYPE — deliberate demo\n")
    findings = lint_file(p)
    assert len(findings) == 1
    assert findings[0].suppressed
    assert findings[0].suppression_reason == "deliberate demo"


def test_standalone_suppression_covers_next_line(tmp_path):
    p = tmp_path / "bad__core__moments.py"
    p.write_text("import torch\n"
                 "# reprolint: disable=RL-DTYPE — demo reason\n"
                 "x = torch.ones(3).double()\n")
    findings = lint_file(p)
    assert [f.suppressed for f in findings] == [True]


def test_reasonless_disable_does_not_suppress(tmp_path):
    p = tmp_path / "bad__core__moments.py"
    p.write_text("import torch\n"
                 "x = torch.ones(3).double()  # reprolint: disable=RL-DTYPE\n")
    findings = lint_file(p)
    codes = {f.code: f.suppressed for f in findings}
    assert codes == {CODE_SUPPRESS: False, "RL-DTYPE": False}


def test_suppression_only_covers_named_code(tmp_path):
    p = tmp_path / "bad__core__moments.py"
    p.write_text("import torch\n"
                 "x = torch.ones(3).double()"
                 "  # reprolint: disable=RL-VMEM — wrong code named\n")
    findings = lint_file(p)
    assert [(f.code, f.suppressed) for f in findings] \
        == [("RL-DTYPE", False)]


# ------------------------------------------------------------- JSON schema
def test_report_json_round_trip():
    report = run_lint([FIXDIR / "bad_recompile.py",
                       FIXDIR / "bad_suppress.py"])
    d = json.loads(report.to_json())
    assert d["version"] == 1
    assert d["files_scanned"] == 2
    assert d["counts"]["RL-RECOMPILE"] >= 1
    back = Report.from_dict(d)
    assert back.findings == report.findings
    assert back.files_scanned == report.files_scanned


def test_report_rejects_unknown_version():
    with pytest.raises(ValueError, match="version"):
        Report.from_dict({"version": 99, "findings": [],
                          "files_scanned": 0})


def test_finding_dict_round_trip():
    f = Finding("RL-DTYPE", "a.py", 3, "msg", col=7, symbol="fn",
                suppressed=True, suppression_reason="why")
    assert Finding.from_dict(f.to_dict()) == f


def test_reports_load_in_either_package():
    ours = run_lint([FIXDIR / "bad_recompile.py"])
    theirs = ref_analysis.run_lint([REF_FIXDIR / "bad_recompile.py"])
    assert ref_analysis.Report.from_dict(json.loads(ours.to_json())) \
        .to_dict() == ours.to_dict()
    assert Report.from_dict(json.loads(theirs.to_json())).to_dict() \
        == theirs.to_dict()


# ------------------------------------------------- agreement with the JAX
def _keys(findings):
    return {(f.code, f.line, f.symbol) for f in live(findings)}


@pytest.mark.parametrize("name", ["bad__runtime__chaos.py",
                                  "bad__serve__fleet.py", "bad_suppress.py"])
def test_port_agrees_with_reference_on_shared_rules(name):
    ours = _keys(lint_file(REF_FIXDIR / name))
    theirs = _keys(ref_analysis.lint_file(REF_FIXDIR / name))
    assert ours and ours == theirs


def test_port_agrees_with_reference_on_dataclass_and_cache_keys():
    """bad_recompile.py's dataclass, f-string and id() cases carry over;
    its jit static-argument cases have no counterpart in the port."""
    carried = ("dataclass field", "f-string", "id()")
    theirs = {(f.code, f.line, f.symbol) for f in
              live(ref_analysis.lint_file(REF_FIXDIR / "bad_recompile.py"))
              if any(c in f.message for c in carried)}
    ours = _keys(lint_file(REF_FIXDIR / "bad_recompile.py"))
    assert len(theirs) == 3 and ours == theirs


# ----------------------------------------------------------- CLI contract
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, env=ENV, timeout=120)


def test_cli_json_exit_codes():
    out = _cli("--format=json", str(FIXDIR / "good_recompile.py"))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["counts"] == {}

    out = _cli("--format=json", str(FIXDIR / "bad_recompile.py"))
    assert out.returncode == 1, out.stderr
    report = json.loads(out.stdout)
    assert report["counts_unsuppressed"]["RL-RECOMPILE"] >= 1

    out = _cli("--select=RL-NOPE")
    assert out.returncode == 2
    assert "unknown code" in out.stderr


def test_cli_output_and_list_codes(tmp_path):
    dest = tmp_path / "r.json"
    out = _cli("--output", str(dest), str(FIXDIR / "bad_suppress.py"))
    assert out.returncode == 1
    assert json.loads(dest.read_text())["counts"] == {CODE_SUPPRESS: 2}
    out = _cli("--list-codes")
    assert out.returncode == 0
    assert [ln.split()[0] for ln in out.stdout.splitlines()] \
        == sorted(ALL_CODES)


def test_cli_select_filters_codes():
    findings = live(lint_file(FIXDIR / "bad__core__moments.py",
                              select=("RL-VMEM",)))
    assert findings == []


# ---------------------------------------------------------- the meta-test
def test_committed_port_is_finding_free(monkeypatch):
    """The acceptance criterion: zero unsuppressed findings on the port's
    own files (src/repro_torch, examples/torch_*.py, chip_smoke.py)."""
    monkeypatch.chdir(REPO)
    report = run_lint()
    assert report.files_scanned > 50
    scanned = {f.path for f in report.findings}
    assert not any(p.startswith("src/repro/") for p in scanned)
    bad = [f.render() for f in report.unsuppressed]
    assert bad == [], "\n".join(bad)
    # the deliberate f64 exceptions stay visible in the audit trail
    assert report.counts(suppressed=True).get("RL-DTYPE", 0) >= 4


def test_default_roots_are_the_ports_files(monkeypatch):
    from repro_torch.analysis import default_roots, discover_files
    monkeypatch.chdir(REPO)
    files = {p.as_posix() for p in discover_files(default_roots())}
    assert "chip_smoke.py" in files
    assert "examples/torch_quickstart.py" in files
    assert "src/repro_torch/analysis/core.py" in files
    assert not any(f.startswith("src/repro/") for f in files)
    assert "examples/quickstart.py" not in files


# -------------------------------------------------------------- sanitizers
def test_compile_counter_sees_a_new_step_key():
    step = StepFunction(lambda x: x * 3.0)
    with CompileCounter() as c:
        step(torch.ones(5))
    assert c.count == 1 and c.names == ["step <lambda>"]
    with CompileCounter() as c2:
        step(torch.full((5,), 2.0))       # same shape and dtype: same key
    assert c2.count == 0


def test_assert_no_recompiles_trips_on_new_shape():
    def g(x):
        return x + 1.0
    step = StepFunction(g)
    step(torch.ones(3))
    with assert_no_recompiles("warm"):
        step(torch.ones(3))
    with pytest.raises(AssertionError, match="zero executable compiles"):
        with assert_no_recompiles("cold"):
            step(torch.ones(6))


@pytest.fixture(scope="module")
def warm_engine():
    """A warmed fit server, built at module scope so the function-scoped
    tripwire only sees the warm round."""
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=4,
                                        buckets=(64, 256)), device="cpu")
    eng.warmup()
    return eng


def _round(eng, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for n in (20, 64, 200, 700):
        x = rng.uniform(-1, 1, n).astype(np.float32)
        reqs.append(eng.submit(x, (1 + x - x ** 3).astype(np.float32)))
    eng.run()
    return reqs


@pytest.mark.no_recompile
def test_warm_engine_round_is_compile_free(warm_engine):
    """The autouse tripwire fails this test if a step key is minted."""
    before = warm_engine.compiled_executables()
    reqs = _round(warm_engine, 1)
    assert all(r.done for r in reqs)
    assert warm_engine.compiled_executables() == before


def test_fresh_spec_trips_the_warm_engine(warm_engine):
    from repro_torch import api
    with pytest.raises(AssertionError, match="zero executable compiles"):
        with assert_no_recompiles("novel spec") as c:
            x = np.linspace(-1, 1, 50, dtype=np.float32)
            warm_engine.submit(x, x, spec=api.FitSpec(degree=1))
            warm_engine.run()
    assert c.names == ["step solve"]


def test_fleet_steps_are_counted():
    from repro_torch.serve.fleet import FitFleet, FleetConfig
    fleet = FitFleet(FleetConfig(n_workers=2, chunk_width=256,
                                 fit=FitServeConfig(degree=3)),
                     device="cpu")
    with CompileCounter() as c:
        base = fleet.warmup()
    assert c.count == base > 0


def test_a_kernel_build_is_counted(monkeypatch, tmp_path):
    """build.build() run with a stand-in compiler (it writes the file each
    ``-o`` names) in a fresh build directory counts as one compile; the
    cached library on the next call counts none."""
    from repro_torch.kernels import build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    with CompileCounter() as c:
        lib, _ = build.build()
        build.build()
    assert c.names == [f"nvcc {lib.name}"]
    assert not build.BUILD_OBSERVERS


def test_nan_origin_names_the_boundary():
    from repro_torch.core import solve as solve_mod
    eye = torch.eye(3)
    b = torch.ones(3)
    with nan_origin():
        out = solve_mod.solve(eye, b)            # clean inputs pass through
        assert torch.allclose(out, torch.ones(3))
        poisoned = torch.eye(3)
        poisoned[1, 1] = float("nan")
        with pytest.raises(NaNOriginError) as exc:
            solve_mod.solve(poisoned, b)
    assert "solve" in str(exc.value) and "non-finite" in str(exc.value)
    assert exc.value.argument == "a"
    # restored on exit: the wrapper is gone
    assert not hasattr(solve_mod.solve, "__wrapped__")
    assert not hasattr(solve_mod.solve_with_fallback, "__wrapped__")


def test_nan_origin_checks_solve_with_fallback_inputs():
    from repro_torch.core import solve as solve_mod
    bad = torch.full((3, 3), float("nan"))
    with nan_origin():
        with pytest.raises(NaNOriginError, match="solve_with_fallback"):
            solve_mod.solve_with_fallback(bad, torch.ones(3))


def test_nan_origin_sees_the_servers_solves():
    """The fit server reaches the solvers through the module, so a NaN
    series is caught at the solve boundary inside the step."""
    eng = FitServeEngine(FitServeConfig(degree=2, n_slots=2,
                                        buckets=(64,)), device="cpu")
    x = np.linspace(-1, 1, 40, dtype=np.float32)
    y = x.copy()
    y[3] = np.nan
    with nan_origin():
        eng.submit(x, y)
        with pytest.raises(NaNOriginError, match="solve_with_fallback"):
            eng.run()
