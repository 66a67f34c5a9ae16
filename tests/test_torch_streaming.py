"""Port parity for streaming: ``repro_torch.core.streaming``,
``api.stream_state`` / ``api.stream_result`` and ``interop.stream_state``
against ``repro.core.streaming`` and ``repro.api`` on the same numpy
chunks, on the CPU.

Tolerances:

* running moments (every snapshot field): max|Δ| <= 1e-5 (f32) / 1e-12
  (f64) of the field's max|ref| — two summation orders of a few hundred
  terms per chunk;
* fitted values from the streamed solve: the conformance suite's
  κ-scaled gap 2·max(200·eps·√κ, 50·eps), κ the port's own estimate;
* streaming IRLS: the weights pass through a sort-based MAD scale on both
  sides; values within 1e-4 (f32) / 1e-9 (f64) of max|y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import streaming as jstreaming
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch import api, interop
from repro_torch.core import streaming
from repro_torch.obs.metrics import MetricsRegistry

torch.set_num_threads(1)

CPU = "cpu"
DTYPES = [np.float32, np.float64]
MOM_TOL = {np.float32: 1e-5, np.float64: 1e-12}
IRLS_TOL = {np.float32: 1e-4, np.float64: 1e-9}
FIELDS = ("gram", "vty", "yty", "count", "weight_sum")


def _x64(npd):
    return jax.enable_x64(npd == np.float64)


def _chunks(seed, batch, n_chunks, width, degree, npd, outliers=0.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0.0, 1.0, degree + 1)
    out = []
    for _ in range(n_chunks):
        shape = batch + (width,)
        x = rng.uniform(-1.5, 1.5, shape)
        y = np.polyval(c[::-1], x) + 0.05 * rng.normal(size=shape)
        if outliers:
            hit = rng.uniform(size=shape) < outliers
            y = np.where(hit, y + rng.uniform(2, 5, shape), y)
        w = rng.uniform(0.0, 2.0, shape) * (rng.uniform(size=shape) > 0.2)
        out.append((x.astype(npd), y.astype(npd), w.astype(npd)))
    return out


def _torch_dtype(npd):
    return torch.from_numpy(np.zeros(1, npd)).dtype


def _run_both(jspec, chunks, batch, npd, weighted=False, state_dtype=None):
    """The same chunks through both packages, into a state of the chunks'
    dtype unless ``state_dtype`` says otherwise; returns (ref snapshot,
    ref result as numpy, port state, port result)."""
    sd = state_dtype or npd
    with _x64(npd):
        js = japi.stream_state(jspec, batch, dtype=jnp.dtype(sd))
        for x, y, w in chunks:
            js = jstreaming.update(js, jnp.asarray(x), jnp.asarray(y),
                                   weights=jnp.asarray(w) if weighted
                                   else None)
        jsnap = js.snapshot()
        jres = japi.stream_result(js)
        jout = dict(coeffs=np.asarray(jres.coeffs),
                    sse=np.asarray(jres.report.sse),
                    shift=float(jres.poly.domain_shift),
                    scale=float(jres.poly.domain_scale),
                    best=(None if jres.selection is None
                          else np.asarray(jres.best_degree)),
                    iterations=jres.iterations,
                    converged=(None if jres.converged is None
                               else np.asarray(jres.converged)))
    ts = api.stream_state(interop.fit_spec(jspec), batch,
                          dtype=_torch_dtype(sd), device=CPU)
    for x, y, w in chunks:
        ts = streaming.update(ts, x, y, weights=w if weighted else None)
    return jsnap, jout, ts, api.stream_result(ts)


def _assert_snapshots_close(tsnap, jsnap, npd):
    assert sorted(tsnap) == sorted(jsnap)
    for k, want in jsnap.items():
        if k == "folds":
            _assert_snapshots_close(tsnap[k], want, npd)
            continue
        got = tsnap[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=MOM_TOL[npd] * max(np.abs(want).max(), 1e-30), err_msg=k)


def _values(coeffs, shift, scale, x):
    """Per-series f(x) in float64 by Horner: coeffs (..., m+1), x (..., n)."""
    c = np.asarray(coeffs, np.float64)
    t = (x.astype(np.float64) - shift) * scale
    acc = np.zeros_like(t) + c[..., -1:]
    for k in range(c.shape[-1] - 2, -1, -1):
        acc = acc * t + c[..., k:k + 1]
    return acc


def _assert_values_close(tres, jout, x, npd):
    eps = float(np.finfo(npd).eps)
    cond = float(torch.max(tres.poly.diagnostics.condition))
    tol = 2 * max(200.0 * eps * np.sqrt(cond), 50.0 * eps)
    tv = _values(tres.coeffs.numpy(), float(tres.poly.domain_shift),
                 float(tres.poly.domain_scale), x)
    jv = _values(jout["coeffs"], jout["shift"], jout["scale"], x)
    gap = np.linalg.norm(tv - jv) / (np.linalg.norm(jv) + 1e-30)
    assert gap <= tol, (gap, tol, cond)


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("degree", [1, 3, 7])
@pytest.mark.parametrize("mode", ["plain", "decay", "weights"])
def test_stream_against_reference(npd, degree, mode):
    chunks = _chunks(degree, (3,), 3, 200, degree, npd)
    # degree 7 normalizes in f32, and a stream needs its domain pinned
    jspec = japi.FitSpec(degree=degree,
                         decay=0.99 if mode == "decay" else 1.0,
                         domain=(0.0, 1.0 / 1.5) if degree == 7 else None)
    jsnap, jout, ts, tres = _run_both(jspec, chunks, (3,), npd,
                                      weighted=mode == "weights")
    _assert_snapshots_close(ts.snapshot(), jsnap, npd)
    x = np.concatenate([c[0] for c in chunks], axis=-1)
    _assert_values_close(tres, jout, x, npd)
    # the report rides on the same moments
    np.testing.assert_allclose(tres.report.sse.numpy(), jout["sse"],
                               rtol=0, atol=MOM_TOL[npd] * 10
                               * float(jsnap["yty"].max()))


def test_f64_chunks_into_an_f32_stream():
    """Float64 chunks into the default float32 state: the weighted sums
    promote to float64 and land in the state's float32, as the reference's
    jnp promotion does (the port's ``gram_moments`` used to raise here)."""
    chunks = _chunks(2, (2,), 2, 200, 3, np.float64)
    jsnap, _, ts, _ = _run_both(japi.FitSpec(degree=3, decay=0.99), chunks,
                                (2,), np.float64, state_dtype=np.float32)
    assert ts.moments.gram.dtype == torch.float32
    _assert_snapshots_close(ts.snapshot(), jsnap, np.float32)


@pytest.mark.parametrize("npd", DTYPES)
def test_true_count_survives_decay_underflow(npd):
    """γ^age underflows to 0 in f32 past age ~700 at γ = 0.9: the count
    still comes from the user weights, on both sides."""
    chunks = _chunks(3, (2,), 2, 1000, 2, npd)
    jsnap, _, ts, _ = _run_both(japi.FitSpec(degree=2, decay=0.9), chunks,
                                (2,), npd)
    np.testing.assert_array_equal(ts.snapshot()["count"], jsnap["count"])
    assert (jsnap["count"] == 2000).all()
    assert (ts.moments.weight_sum < 20).all()
    # the decay factor γⁿ is a tensor power in the state's dtype
    assert ts.decay.dtype == _torch_dtype(npd)


@pytest.mark.parametrize("npd", DTYPES)
def test_stream_folds_and_selection_against_reference(npd):
    chunks = _chunks(4, (3,), 5, 150, 3, npd)
    jspec = japi.FitSpec(degree=japi.DegreeSearch(max_degree=5, folds=3),
                         domain=(0.0, 1.0 / 1.5))
    jsnap, jout, ts, tres = _run_both(jspec, chunks, (3,), npd)
    tsnap = ts.snapshot()
    _assert_snapshots_close(tsnap, jsnap, npd)
    assert int(tsnap["fold_index"]) == int(jsnap["fold_index"]) == 5
    assert tsnap["fold_index"].dtype == jsnap["fold_index"].dtype
    np.testing.assert_array_equal(np.asarray(tres.best_degree), jout["best"])
    # the state's own readout, without a spec
    sel = ts.current_selection(criterion="aicc")
    with _x64(npd):
        jst = jstreaming.StreamState.restore(jsnap)
        jsel = jst.current_selection(criterion="aicc")
        jbest = np.asarray(jsel.best_degree)
    np.testing.assert_array_equal(np.asarray(sel.best_degree), jbest)
    with pytest.raises(ValueError, match="cv_folds"):
        streaming.StreamState.create(3, device=CPU).current_selection(
            criterion="cv")


@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_streaming_irls_against_reference(npd, loss):
    chunks = _chunks(5, (3,), 3, 256, 3, npd, outliers=0.1)
    jspec = japi.FitSpec(degree=3, method="irls",
                         irls=japi.IRLSOptions(loss=loss))
    jsnap, jout, ts, tres = _run_both(jspec, chunks, (3,), npd)
    x = np.concatenate([c[0] for c in chunks], axis=-1)
    y = np.concatenate([c[1] for c in chunks], axis=-1)
    tv = _values(tres.coeffs.numpy(), 0.0, 1.0, x)
    jv = _values(jout["coeffs"], 0.0, 1.0, x)
    np.testing.assert_allclose(tv, jv, rtol=0,
                               atol=IRLS_TOL[npd] * np.abs(y).max())
    np.testing.assert_allclose(ts.snapshot()["count"], jsnap["count"])


@pytest.mark.parametrize("npd", DTYPES)
def test_stream_result_lspia_against_reference(npd):
    chunks = _chunks(6, (3,), 3, 200, 3, npd)
    jspec = japi.FitSpec(degree=3, method="lspia", domain=(0.0, 1.0 / 1.5),
                         lspia=japi.LSPIAOptions(momentum=0.5))
    jsnap, jout, ts, tres = _run_both(jspec, chunks, (3,), npd)
    np.testing.assert_array_equal(tres.converged.numpy(), jout["converged"])
    assert abs(tres.iterations - int(jout["iterations"])) <= max(
        2, 0.02 * int(jout["iterations"]))
    scale = max(1.0, np.abs(jout["coeffs"]).max())
    np.testing.assert_allclose(tres.coeffs.numpy(), jout["coeffs"],
                               atol={np.float32: 2e-3,
                                     np.float64: 1e-6}[npd] * scale)


@pytest.mark.parametrize("npd", DTYPES)
def test_reference_snapshot_restores_and_continues(npd):
    """A reference state carried across mid-stream (interop.stream_state)
    continues to the reference's result; the snapshot layouts are the
    same dict of numpy arrays, and the port's snapshot restores in the
    reference too."""
    chunks = _chunks(7, (2,), 4, 128, 3, npd)
    jspec = japi.FitSpec(degree=japi.DegreeSearch(max_degree=3, folds=2),
                         domain=(0.0, 1.0 / 1.5))
    with _x64(npd):
        js = japi.stream_state(jspec, (2,))
        for x, y, _ in chunks[:2]:
            js = jstreaming.update(js, jnp.asarray(x), jnp.asarray(y))
        ts = interop.stream_state(js, device=CPU)
        assert ts.spec == interop.fit_spec(jspec)
        for k, v in ts.snapshot().items():       # bit-equal on arrival
            if k != "folds":
                np.testing.assert_array_equal(v, js.snapshot()[k])
        back = jstreaming.StreamState.restore(ts.snapshot(), spec=jspec)
        for x, y, _ in chunks[2:]:
            js = jstreaming.update(js, jnp.asarray(x), jnp.asarray(y))
            back = jstreaming.update(back, jnp.asarray(x), jnp.asarray(y))
        jsnap = js.snapshot()
        for k in FIELDS:
            np.testing.assert_array_equal(back.snapshot()[k], jsnap[k])
    from_snap = interop.stream_state(
        jstreaming.StreamState.restore(js.snapshot()).snapshot(),
        spec=ts.spec, device=CPU)
    assert from_snap.fold_index == int(jsnap["fold_index"])
    for x, y, _ in chunks[2:]:
        ts = streaming.update(ts, x, y)
    _assert_snapshots_close(ts.snapshot(), jsnap, npd)


def test_snapshot_restore_is_bit_exact_mid_stream():
    chunks = _chunks(8, (3,), 4, 100, 3, np.float32)
    spec = api.FitSpec(degree=api.DegreeSearch(max_degree=4, folds=3),
                       decay=0.999, domain=(0.0, 1.0 / 1.5))
    st = api.stream_state(spec, (3,), device=CPU)
    snap = None
    for i, (x, y, w) in enumerate(chunks):
        st = streaming.update(st, x, y, weights=w)
        if i == 1:
            snap = st.snapshot()
    rs = streaming.StreamState.restore(snap, spec=spec, device=CPU)
    for x, y, w in chunks[2:]:
        rs = streaming.update(rs, x, y, weights=w)
    for a, b in ((rs.moments, st.moments), (rs.fold_moments,
                                            st.fold_moments)):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert rs.fold_index == st.fold_index == 4
    assert torch.equal(api.stream_result(rs).coeffs,
                       api.stream_result(st).coeffs)


UNIT_CASES = {
    # case: (FitSpec arguments of a package's api, chunks' dtype, user
    # weights, every pass handed a weight array)
    "plain": (lambda a: dict(degree=3), np.float32, False, False),
    "folds": (lambda a: dict(degree=a.DegreeSearch(max_degree=3, folds=3),
                             domain=(0.0, 1.0 / 1.5)),
              np.float32, False, False),
    "folds_decay": (lambda a: dict(degree=a.DegreeSearch(max_degree=3,
                                                         folds=3),
                                   domain=(0.0, 1.0 / 1.5), decay=0.99),
                    np.float32, False, True),
    "weights": (lambda a: dict(degree=3), np.float32, True, True),
    "irls": (lambda a: dict(degree=3, method="irls"), np.float32, False,
             True),
    "decay": (lambda a: dict(degree=3, decay=0.99), np.float32, False, True),
    "wide_chunks": (lambda a: dict(degree=3), np.float64, False, True),
}


def _assert_states_equal(a, b):
    for ma, mb in ((a.moments, b.moments), (a.fold_moments, b.fold_moments)):
        assert (ma is None) == (mb is None)
        for f in FIELDS if ma is not None else ():
            assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    assert a.fold_index == b.fold_index


@pytest.mark.parametrize("engine", ["reference", "kernel"])
@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_decay_leaves_the_ladder_out_with_the_same_bits(case, engine):
    """At γ = 1 a stream hands the moment pass its chunks' own weights,
    none where there are none, and rescales nothing.  Every field, fold
    partials included, keeps the bits of the ladder path (the state
    without ``host_decay``, which folds as γ < 1 does) and, without user
    weights, of the same chunks weighted by explicit ones; and is the
    reference's to the module's tolerance.  A γ < 1 stream, user or IRLS
    weights and chunks wider than the state's dtype still hand the pass a
    weight array.  A snapshot, in its unchanged layout, restores the host
    γ from its ``decay`` and continues with the same bits."""
    from repro_torch import engine as engine_lib
    kw, npd, user_w, weighted = UNIT_CASES[case]
    chunks = _chunks(11, (3,), 4, 96, 3, npd)

    def run(state, chunks, weighted=weighted, ones=False):
        engine_lib.reset_moment_counter()
        for x, y, w in chunks:
            w = np.ones_like(x) if ones else w if user_w else None
            state = streaming.update(state, x, y, weights=w)
        counter = engine_lib.moment_counter()
        assert counter["calls"] >= len(chunks)
        assert counter["weighted"] == (counter["calls"] if weighted else 0)
        return state

    spec = api.FitSpec(engine=engine, **kw(api))
    start = spec.streaming((3,), dtype=torch.float32, device=CPU)
    assert start.host_decay == float(start.decay) == float(
        np.float32(spec.decay))
    got = run(start, chunks)
    _assert_states_equal(got, run(
        dataclasses.replace(start, host_decay=None), chunks, weighted=True))
    if not weighted:
        _assert_states_equal(got, run(start, chunks, weighted=True,
                                      ones=True))
    with _x64(npd):
        js = japi.stream_state(japi.FitSpec(**kw(japi)), (3,),
                               dtype=jnp.float32)
        for x, y, w in chunks:
            js = jstreaming.update(js, jnp.asarray(x), jnp.asarray(y),
                                   weights=jnp.asarray(w) if user_w
                                   else None)
        _assert_snapshots_close(got.snapshot(), js.snapshot(), np.float32)
    snap = run(start, chunks[:2]).snapshot()
    assert sorted(snap) == sorted(
        FIELDS + ("decay",) + (("folds", "fold_index")
                               if start.fold_moments is not None else ()))
    back = streaming.StreamState.restore(snap, spec=spec, device=CPU)
    assert back.host_decay == float(snap["decay"]) == start.host_decay
    _assert_states_equal(run(back, chunks[2:]), got)


def _offers():
    """(source, seq, chunk index): in order, a duplicate, a reordered
    pair, a chunk beyond the reorder window, and a held duplicate."""
    return [(0, 1, 0), (1, 1, 1), (0, 1, 0), (1, 3, 2), (1, 3, 2),
            (1, 2, 3), (0, 2, 4), (2, 9, 5), (2, 1, 6), (0, 3, 7)]


@pytest.mark.parametrize("npd", DTYPES)
def test_async_ingestor_against_reference(npd):
    chunks = _chunks(9, (), 8, 64, 3, npd)
    with _x64(npd):
        jreg = JRegistry()
        jing = jstreaming.AsyncChunkIngestor(
            jstreaming.StreamState.create(3, dtype=jnp.dtype(npd)), 3,
            staleness=1, reorder_window=4, metrics=jreg)
        jacks = [jing.offer(s, q, *chunks[i][:2]) for s, q, i in _offers()]
        jsnap = jing.state.snapshot()
    treg = MetricsRegistry()
    ting = streaming.AsyncChunkIngestor(
        streaming.StreamState.create(3, dtype=_torch_dtype(npd),
                                     device=CPU),
        3, staleness=1, reorder_window=4, metrics=treg)
    tacks = [ting.offer(s, q, *chunks[i][:2]) for s, q, i in _offers()]
    assert tacks == jacks
    assert ting.applied == jing.applied
    assert (ting.duplicates, ting.buffered, ting.overflowed) == (
        jing.duplicates, jing.buffered, jing.overflowed)
    assert ting.lag() == jing.lag() and ting.fresh() == jing.fresh()
    assert ting.stale_sources() == jing.stale_sources()
    assert treg.snapshot() == jreg.snapshot()
    _assert_snapshots_close(ting.state.snapshot(), jsnap, npd)
    with pytest.raises(ValueError, match="decay"):
        streaming.AsyncChunkIngestor(
            streaming.StreamState.create(3, decay=0.9, device=CPU), 2)
    with pytest.raises(ValueError, match="out of range"):
        ting.offer(5, 1, *chunks[0][:2])


def test_kernel_path_against_pallas_interpret():
    """engine="kernel_packed": the reference's packed Pallas kernel in
    interpret mode, the port's packed launcher's plain version on the CPU
    (the smallest shapes: interpret mode is slow)."""
    chunks = _chunks(10, (2,), 2, 128, 3, np.float32)
    jspec = japi.FitSpec(degree=3, engine="kernel_packed")
    jsnap, _, ts, _ = _run_both(jspec, chunks, (2,), np.float32)
    _assert_snapshots_close(ts.snapshot(), jsnap, np.float32)
    plan = streaming.update_plan(ts, (2, 128), torch.float32)
    assert plan.path == "kernel_packed" and plan.reason == "forced"


@pytest.mark.parametrize("shape,backend,path", [
    ((4, 1000), "cuda", "kernel_packed"),
    ((1 << 16,), "cuda", "kernel_plain"),
    ((1000,), "cuda", "reference"),
    ((4, 1000), None, "reference"),
])
def test_update_plans_on_the_state_device(shape, backend, path):
    """``update`` plans with the state's device: on a CPU state the
    reference path; the CUDA what-if takes the packed kernel for a batch
    and the plain kernel for one long series, as on the card.  A streaming
    IRLS state plans its reweighting passes the same way."""
    for spec in (api.FitSpec(degree=3),
                 api.FitSpec(degree=3, method="irls")):
        st = api.stream_state(spec, shape[:-1], device=CPU)
        plan = streaming.update_plan(st, shape, torch.float32,
                                     backend=backend)
        assert plan.path == path, plan.describe()
        assert plan.weighted
        if backend is None:
            assert "backend=cpu" in plan.reason


def test_stream_state_validation():
    with pytest.raises(ValueError, match="pin it"):
        api.stream_state(api.FitSpec(degree=3, numerics=api.NumericsPolicy(
            normalize=True)), device=CPU)
    with pytest.raises(ValueError, match="raw Vandermonde"):
        api.stream_state(api.FitSpec(degree=3, numerics=api.NumericsPolicy(
            solver="qr_vandermonde")), device=CPU)
    st = api.FitSpec(degree=2, decay=0.5).streaming((2,), device=CPU)
    assert st.moments.gram.shape == (2, 3, 3) and float(st.decay) == 0.5
