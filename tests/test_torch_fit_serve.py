"""Port parity for the fit server: ``repro_torch.serve.FitServeEngine``
against ``repro.serve.FitServeEngine`` on the same submit sequences, on
the CPU.

Both engines are host loops over the same bucket/slot bookkeeping, so the
step at which each request completes, its chosen degree, its count and
the ``compiled_executables()`` counts are equal, and with observability on
the trace's JSONL export is byte-identical (tick events hold only host
integers).  Numbers carry the tolerances of the moment path: coefficients
within 2e-3 (f32) / 1e-9 (f64) of max(1, max|c|) — two float orders of
the same sums through a solve of κ ≲ 10⁴ —, SSE and R within 1e-3 / 1e-9
relative (SSE is the difference yᵀy − 2cᵀb + cᵀAc and loses the digits
the cancellation takes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import obs as jobs
from repro.launch import serve as jlaunch
from repro.serve import FitServeConfig as JConfig
from repro.serve import FitServeEngine as JEngine
from repro_torch import api, interop
from repro_torch import obs as tobs
from repro_torch.core import streaming
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import FitServeConfig, FitServeEngine

torch.set_num_threads(1)

CPU = "cpu"
COEF_TOL = {np.float32: 2e-3, np.float64: 1e-9}
REP_TOL = {np.float32: 1e-3, np.float64: 1e-9}


def _x64(npd):
    return jax.enable_x64(npd == np.float64)


def _trace(seed, n_reqs, lo, hi, degree=3, outliers=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_reqs):
        n = int(rng.integers(lo, hi + 1))
        x = rng.uniform(-2, 2, n).astype(np.float32)
        coef = rng.normal(0, 1, degree + 1)
        y = np.polyval(coef[::-1], x) + rng.normal(0, 0.1, n)
        if outliers:
            y = np.where(rng.uniform(size=n) < outliers,
                         y + rng.uniform(5, 20, n), y)
        out.append((x, y.astype(np.float32)))
    return out


# the request mix of the chip run: default fixed, auto, Huber IRLS,
# moment-space LSPIA, nested degree 2 with ridge
JSPECS = [None, "auto",
          japi.FitSpec(degree=3, method="irls",
                       irls=japi.IRLSOptions(loss="huber")),
          japi.FitSpec(degree=3, method="lspia"),
          japi.FitSpec(degree=2, ridge=1e-6)]


def _submit(eng, x, y, jspec, port):
    if jspec is None:
        return eng.submit(x, y)
    if jspec == "auto":
        return eng.submit(x, y, degree="auto")
    return eng.submit(x, y, spec=interop.fit_spec(jspec) if port else jspec)


def _engines(npd, obs=False, **cfg):
    with _x64(npd):
        jeng = JEngine(JConfig(dtype=jnp.dtype(npd), **cfg),
                       obs=jobs.Observability.on() if obs else None)
    teng = FitServeEngine(
        FitServeConfig(dtype=torch.from_numpy(np.zeros(1, npd)).dtype,
                       **cfg),
        obs=tobs.Observability.on(device=CPU) if obs else None, device=CPU)
    return jeng, teng


def _drive(eng, reqs, npd):
    """Run to completion; the step at which each request completed."""
    done_at = {}
    with _x64(npd):
        while eng.pending:
            eng.step()
            for r in reqs:
                if r.done and r.uid not in done_at:
                    done_at[r.uid] = eng._step_no
    return done_at


def _serve(eng, traffic, npd, port):
    reqs = []
    with _x64(npd):
        for i, (x, y) in enumerate(traffic):
            reqs.append(_submit(eng, x, y, JSPECS[i % len(JSPECS)], port))
    return reqs, _drive(eng, reqs, npd)


def test_same_traffic_same_steps_and_results():
    """float32 pools.  (The reference server cannot run a float64 pool:
    its ``lax.cond`` between the reweighted float64 weights and the float32
    padding weights refuses branches of two dtypes; the port's float64
    pool is held against float64 least squares below.)"""
    npd = np.float32
    jeng, teng = _engines(npd, n_slots=3, buckets=(64, 256))
    with _x64(npd):
        jw = jeng.warmup()
    assert teng.warmup() == jw
    traffic = _trace(1, 30, 5, 700) + _trace(2, 5, 300, 900, outliers=0.1)
    jreqs, jdone = _serve(jeng, traffic, npd, port=False)
    treqs, tdone = _serve(teng, traffic, npd, port=True)
    assert tdone == jdone
    assert teng.compiled_executables() == jeng.compiled_executables()
    assert teng.points_ingested == jeng.points_ingested
    for j, t in zip(jreqs, treqs):
        assert t.done and t.degree == j.degree and t.count == j.count
        assert t.auto == j.auto
        scale = max(1.0, np.abs(j.coeffs).max())
        np.testing.assert_allclose(t.coeffs, j.coeffs,
                                   atol=COEF_TOL[npd] * scale,
                                   err_msg=f"req {j.uid}")
        np.testing.assert_allclose(t.sse, j.sse, rtol=REP_TOL[npd],
                                   atol=REP_TOL[npd])
        np.testing.assert_allclose(t.r, j.r, rtol=REP_TOL[npd])
        if j.auto:
            assert set(t.scores) == set(j.scores)
            np.testing.assert_allclose(t.scores["aicc"], j.scores["aicc"],
                                       rtol=REP_TOL[npd])


def test_float64_pool_against_float64_least_squares():
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=3,
                                        buckets=(64, 256),
                                        dtype=torch.float64), device=CPU)
    traffic = _trace(8, 12, 10, 700)
    reqs = [eng.submit(x, y) for x, y in traffic]
    eng.run()
    for (x, y), r in zip(traffic, reqs):
        # the pool widens the accumulation, not the float32 power ladder
        # (np.vander would compute the powers in float64)
        cols = [np.ones_like(x)]
        for _ in range(3):
            cols.append(cols[-1] * x)
        v = np.stack(cols, -1).astype(np.float64)
        g = v.T @ v + 1e-9 * np.eye(4)
        want = np.linalg.solve(g, v.T @ y.astype(np.float64))
        np.testing.assert_allclose(r.coeffs, want, rtol=0,
                                   atol=COEF_TOL[np.float64]
                                   * max(1.0, np.abs(want).max()))


def test_compiled_executables_track_the_reference():
    """Warmup, steady churn, then a novel spec: the port's step keys count
    what the reference's jit caches count at every stage."""
    jeng, teng = _engines(np.float32, n_slots=3, buckets=(64, 256))
    assert teng.warmup() == jeng.warmup() == len(teng.buckets) + 2
    for x, y in _trace(3, 12, 5, 600):
        jeng.submit(x, y)
        teng.submit(x, y)
    jeng.run()
    teng.run()
    assert teng.compiled_executables() == jeng.compiled_executables() \
        == len(teng.buckets) + 2
    for eng, spec in ((jeng, japi.FitSpec(degree=1, ridge=1e-3)),
                      (teng, api.FitSpec(degree=1, ridge=1e-3))):
        for x, y in _trace(4, 4, 5, 600):
            eng.submit(x, y, spec=spec)
        eng.run()
    assert teng.compiled_executables() == jeng.compiled_executables() \
        == len(teng.buckets) + 3


def test_trace_jsonl_and_metrics_are_byte_identical(tmp_path):
    jeng, teng = _engines(np.float32, obs=True, n_slots=2, buckets=(64,))
    traffic = _trace(5, 9, 5, 300)
    _serve(jeng, traffic, np.float32, port=False)
    _serve(teng, traffic, np.float32, port=True)
    jeng.obs.tracer.export_jsonl(str(tmp_path / "ref.jsonl"))
    teng.obs.tracer.export_jsonl(str(tmp_path / "port.jsonl"))
    ref = (tmp_path / "ref.jsonl").read_bytes()
    assert ref and (tmp_path / "port.jsonl").read_bytes() == ref
    tobs.assert_valid(teng.obs.tracer.events)
    assert teng.obs.metrics.render_prometheus() \
        == jeng.obs.metrics.render_prometheus()
    assert teng.obs.metrics.snapshot() == jeng.obs.metrics.snapshot()


def test_fused_solve_matches_standalone_solve():
    """The fused ingest+solve answers the default spec from the same
    ``_spec_solve_from_state`` the standalone solve runs: re-solving the
    bucket's state reproduces the served result bit for bit."""
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=2, buckets=(128,)),
                         device=CPU)
    reqs = [eng.submit(x, y) for x, y in _trace(13, 2, 100, 100)]
    eng.run()
    b = eng.buckets[0]
    coeffs, sse, r, count, cond, fb = (a.numpy() for a in
                                       eng._solve(b.state, eng.fixed_spec))
    for s, req in enumerate(reqs):
        np.testing.assert_array_equal(req.coeffs, coeffs[s, :4])
        assert req.sse == sse[s] and req.r == r[s] and req.count == count[s]


@pytest.mark.parametrize("ridge", [0.0, 1e-3])
def test_server_and_stream_readout_share_the_lspia_solve(ridge):
    """A request's moment-space LSPIA solve and ``api.stream_result`` of a
    stream under the same spec run one helper: on the same state they
    agree bit for bit."""
    from repro_torch.serve import fit_engine
    spec = api.FitSpec(degree=3, method="lspia", ridge=ridge,
                       lspia=api.LSPIAOptions(momentum=0.5))
    st = api.stream_state(spec, (4,), device=CPU)
    for x, y in _trace(17, 3, 300, 300)[:1] * 2:
        st = streaming.update(st, np.stack([x] * 4), np.stack([y] * 4))
    res = api.stream_result(st)
    coeffs, sse, *_ = fit_engine._spec_solve_from_state(st, spec, 3)
    assert torch.equal(res.poly.coeffs, coeffs)
    assert torch.equal(res.report.sse, sse)


@pytest.mark.parametrize("backend,path", [(None, "reference"),
                                          ("cuda", "kernel_packed")])
def test_bucket_ingest_plans(backend, path):
    """Every bucket ingest (and each IRLS reweighting pass, which plans the
    same way) takes the packed kernel on the card: the CUDA what-if on
    each bucket's state; the CPU state plans the reference path."""
    eng = FitServeEngine(FitServeConfig(degree=3, n_slots=256,
                                        buckets=(64, 4096)), device=CPU)
    for b in eng.buckets:
        plan = streaming.update_plan(b.state, (256, b.width), torch.float32,
                                     eng.spec.engine, eng.spec.basis,
                                     backend=backend)
        assert plan.path == path, plan.describe()


def test_long_series_and_slot_reuse_against_polyfit():
    eng = FitServeEngine(FitServeConfig(degree=2, n_slots=1,
                                        buckets=(32, 128)), device=CPU)
    rng = np.random.default_rng(4)
    wild = eng.submit(rng.uniform(-100, 100, 200).astype(np.float32),
                      rng.normal(0, 1000, 200).astype(np.float32))
    (x, y), = _trace(6, 1, 2000, 2000, degree=2)
    long_req = eng.submit(x, y)
    xs = np.linspace(-1, 1, 30).astype(np.float32)
    clean = eng.submit(xs, (2.0 + 3.0 * xs + 0.5 * xs ** 2)
                       .astype(np.float32))
    eng.run()
    assert wild.done and long_req.count == 2000
    ref = api.fit(x, y, api.FitSpec(degree=2), device=CPU)
    np.testing.assert_allclose(long_req.coeffs, ref.coeffs.numpy(),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(clean.coeffs, [2.0, 3.0, 0.5], atol=1e-3)


def test_kernel_engine_on_the_cpu_plain_versions():
    """engine="kernel": the bucket ingest plans the packed kernel and runs
    its plain version on the CPU; results match the reference path."""
    traffic = _trace(7, 6, 20, 200)
    out = {}
    for engine in ("kernel", "reference"):
        eng = FitServeEngine(FitServeConfig(degree=3, n_slots=3,
                                            buckets=(128,), engine=engine),
                             device=CPU)
        reqs = [eng.submit(x, y) for x, y in traffic]
        eng.run()
        out[engine] = np.stack([r.coeffs for r in reqs])
    np.testing.assert_allclose(out["kernel"], out["reference"], rtol=1e-3,
                               atol=1e-4)


def test_submit_validation_matches_reference():
    jeng, teng = _engines(np.float32, n_slots=1, buckets=(32,))
    bad = [dict(x=np.ones(3), y=np.ones(4)), dict(x=np.ones(0), y=np.ones(0)),
           dict(x=np.ones(2), y=np.ones(2)),
           dict(x=np.ones(8), y=np.ones(8), degree=2),
           dict(x=np.ones(8), y=np.ones(8), degree=3,
                spec=japi.FitSpec(degree=3)),
           dict(x=np.ones(8), y=np.ones(8), spec=japi.FitSpec(degree=4)),
           dict(x=np.ones(8), y=np.ones(8),
                spec=japi.FitSpec(degree=3, decay=0.5)),
           dict(x=np.ones(8), y=np.ones(8),
                spec=japi.FitSpec(degree=3, basis="chebyshev"))]
    for kw in bad:
        tkw = dict(kw)
        if "spec" in tkw:
            tkw["spec"] = interop.fit_spec(tkw["spec"])
        with pytest.raises(ValueError):
            jeng.submit(**kw)
        with pytest.raises(ValueError):
            teng.submit(**tkw)
    with pytest.raises(ValueError, match="ascend"):
        FitServeEngine(FitServeConfig(buckets=(256, 64)), device=CPU)
    with pytest.raises(ValueError, match="fold"):
        FitServeEngine(FitServeConfig(select_criterion="cv"), device=CPU)
    with pytest.raises(RuntimeError, match="idle"):
        teng.submit(np.ones(8), np.ones(8))
        teng.warmup()


def test_launch_serve_fits_prints_the_reference_summary(capsys):
    argv = ["--requests", "12", "--slots", "4", "--buckets", "64", "256",
            "--max-n", "900", "--obs"]
    jlaunch.main(argv)
    ref = capsys.readouterr().out.splitlines()
    assert tlaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    # the same traffic: fits, points, executables and the first requests
    assert got[0].split(" in ")[0] == ref[0].split(" in ")[0]
    assert got[0].split("Mpts/s, ")[1] == ref[0].split("Mpts/s, ")[1]
    assert [ln.split(" R=")[0] for ln in got[1:4]] == \
        [ln.split(" R=")[0] for ln in ref[1:4]]
    assert got[4] == ref[4]      # the obs counters and latency quantiles


def test_new_entry_points_default_to_cuda(monkeypatch):
    """Streaming, LSPIA, the server, the SLO board and the launcher run on
    the card unless the caller asks for the CPU: without CUDA they raise
    instead of falling back."""
    from repro_torch import core
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.linspace(-1, 1, 16, dtype=np.float32)
    calls = [
        lambda: api.stream_state(api.FitSpec(degree=3)),
        lambda: api.FitSpec(degree=3).streaming(),
        lambda: streaming.StreamState.create(3),
        lambda: streaming.StreamState.restore(
            streaming.StreamState.create(3, device=CPU).snapshot()),
        lambda: api.fit(x, x, api.FitSpec(degree=1, method="lspia")),
        lambda: core.lspia_fit(x, x, 1),
        lambda: FitServeEngine(),
        lambda: tobs.Observability.on().slo.watch("q", 1.0),
        lambda: tlaunch.main(["--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("workload,item", [("fleet", "item 11"),
                                           ("tokens", "item 15")])
def test_launch_serve_unported_workloads_exit_nonzero(workload, item,
                                                      capsys):
    """No workload is left unported: the fleet (item 11) and token serving
    (item 15) run and name no item, and no workload exits 2."""
    argv = ["--workload", workload, "--requests", "4", "--device", "cpu"]
    if workload == "tokens":
        argv.append("--smoke")
    assert tlaunch.main(argv) == 0
    assert item not in capsys.readouterr().err
    assert not hasattr(tlaunch, "NOT_PORTED")
