"""Port parity for degree selection: ``repro_torch.select`` and the
DegreeSearch surfaces of ``api.fit`` / ``core.polyfit`` against
``repro.select`` and ``repro.api`` on the same numpy inputs, on the CPU.

Data: noisy series with a planted degree drawn in the Chebyshev basis
(leading coefficient bounded away from zero, SNR 10), so the winning
degree is not a near tie.  Tolerances:

* scores and CV sums: rtol 2e-4 in float32 (sums of ~10² squared
  residuals of an O(1) fit, each side solved by its own LAPACK), 1e-9 in
  float64; +inf entries must sit in the same places;
* ladder coefficients: atol 5e-3 in float32 on the [-1, 1] domain, whose
  Grams are well conditioned up to degree 6 (κ < 1e5, f32 eps·κ ≈ 1e-2 of
  the SVD-guarded rungs), 1e-8 in float64;
* selected degrees: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import core as jcore
from repro import select as jselect
from repro_torch import api, core, engine, interop, select
from repro_torch.select import criteria

torch.set_num_threads(1)

CPU = "cpu"
DTYPES = [np.float32, np.float64]
RTOL = {np.float32: 2e-4, np.float64: 1e-9}
ATOL = {np.float32: 5e-3, np.float64: 1e-8}


def _planted(seed, degree, shape, snr=10.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    c = rng.normal(0.0, 0.5, degree + 1)
    c[degree] = rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 1.5)
    sig = np.polynomial.chebyshev.chebval(x, c)
    y = sig + (np.std(sig) / snr) * rng.normal(0, 1, shape)
    return x, y


def _x64(npd):
    return jax.enable_x64(npd == np.float64)


def _t(a, npd):
    return torch.from_numpy(np.asarray(a, npd))


def _close(got, want, npd, atol=0.0):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL[npd], atol=atol)


# ------------------------------------------------------------- criteria
@pytest.mark.parametrize("npd", DTYPES)
def test_score_table_against_reference_with_inf_rules(npd):
    rng = np.random.default_rng(1)
    sse = np.sort(rng.uniform(0.5, 20.0, (5, 7)), axis=-1)[:, ::-1].copy()
    sse[0, 4:] = 0.0                       # exact fit: log floor, not -inf
    n = np.array([3.0, 4.0, 6.0, 40.0, 200.0])   # n <= k and n <= k + 1
    sst = rng.uniform(20.0, 40.0, 5)
    cv = rng.uniform(1.0, 5.0, (5, 7))
    se = rng.uniform(0.0, 0.3, (5, 7))
    with _x64(npd):
        want = jselect.score_table(jnp.asarray(sse, npd), jnp.asarray(n, npd),
                                   jnp.asarray(sst, npd), jnp.asarray(cv, npd),
                                   jnp.asarray(se, npd))
        bare = jselect.score_table(jnp.asarray(sse, npd), jnp.asarray(n, npd),
                                   jnp.asarray(sst, npd))
    got = select.score_table(_t(sse, npd), _t(n, npd), _t(sst, npd),
                             _t(cv, npd), _t(se, npd))
    got_bare = select.score_table(_t(sse, npd), _t(n, npd), _t(sst, npd))
    for name in criteria.REPORTED + ("cv_se",):
        _close(getattr(got, name), getattr(want, name), npd)
        _close(getattr(got_bare, name), getattr(bare, name), npd)
    assert got.max_degree == 6
    assert bool(torch.isinf(got.aicc[0, 1:]).all())   # 3 points: k >= 2 unfit
    with pytest.raises(ValueError):
        got.by_name("mse")


@pytest.mark.parametrize("criterion", criteria.CRITERIA)
def test_best_degree_every_criterion_and_ties(criterion):
    rng = np.random.default_rng(2)
    vals = rng.uniform(0.0, 1.0, (6, 5)).astype(np.float32)
    vals[0] = [3.0, 1.0, 1.0, 2.0, 1.0]   # ties: the lower degree wins
    vals[1] = np.inf                       # all +inf: degree 0
    se = rng.uniform(0.0, 0.2, (6, 5)).astype(np.float32)
    fields = {k: vals for k in ("sse", "r2", "aic", "aicc", "bic", "gcv",
                                "cv")}
    want = jselect.best_degree(jselect.ScoreTable(
        **{k: jnp.asarray(v) for k, v in fields.items()},
        cv_se=jnp.asarray(se)), criterion)
    got = select.best_degree(select.ScoreTable(
        **{k: torch.from_numpy(v) for k, v in fields.items()},
        cv_se=torch.from_numpy(se)), criterion)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 0
    if criterion != "cv":
        assert int(got[0]) == 1
    with pytest.raises(ValueError):
        select.best_degree(select.ScoreTable(
            **{k: torch.from_numpy(v) for k, v in fields.items()},
            cv_se=torch.from_numpy(se)), "r2")


# --------------------------------------------------------------- ladder
@pytest.mark.parametrize("npd", DTYPES)
def test_solve_ladder_against_reference(npd):
    x, y = _planted(3, 3, (3, 300))
    with _x64(npd):
        jm = jcore.gram_moments(jnp.asarray(x, npd), jnp.asarray(y, npd), 6)
        jc, jk, jf = jselect.solve_ladder(jm, normalized=True)
        jc, jk, jf = np.asarray(jc), np.asarray(jk), np.asarray(jf)
    tm = interop.moments(jm, CPU)
    tc, tk, tf = select.solve_ladder(tm, normalized=True)
    assert tc.shape == (3, 7, 7) and tk.shape == (3, 7)
    np.testing.assert_allclose(tc.double().numpy(), jc, atol=ATOL[npd],
                               rtol=0)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tk.double().numpy(), jk, rtol=1e-2)
    # zero padding past each rung
    for d in range(7):
        assert np.abs(tc[:, d, d + 1:].numpy()).max(initial=0.0) == 0.0


@pytest.mark.parametrize("npd", DTYPES)
def test_sweep_from_moments_scores_against_reference(npd):
    x, y = _planted(4, 2, (2, 257))
    with _x64(npd):
        jx, jy = jnp.asarray(x, npd), jnp.asarray(y, npd)
        jf = jselect.fold_moments(jx, jy, 5, 5)
        jtot = jselect.sum_folds(jf)
        want = jselect.sweep_from_moments(jtot, fold_moments=jf,
                                          normalized=True)
        wsse = np.asarray(want.scores.sse)
        wcv = np.asarray(want.scores.cv)
        wbic = np.asarray(want.scores.bic)
        wbest = np.asarray(want.best("cv"))
    got = select.sweep_from_moments(interop.moments(jtot, CPU),
                                    fold_moments=interop.moments(jf, CPU),
                                    normalized=True)
    _close(got.scores.sse, wsse, npd)
    _close(got.scores.cv, wcv, npd)
    _close(got.scores.bic, wbic, npd)
    np.testing.assert_array_equal(got.best("cv").numpy(), wbest)


# ------------------------------------------------------------- cross-val
@pytest.mark.parametrize("npd", DTYPES)
def test_fold_moments_and_cv_scores_against_reference(npd):
    x, y = _planted(5, 3, (2, 3, 203))       # ragged: 203 = 5·41 − 2
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 1.5, x.shape) * (rng.uniform(size=x.shape) > 0.1)
    with _x64(npd):
        jx, jy, jw = (jnp.asarray(a, npd) for a in (x, y, w))
        jf = jselect.fold_moments(jx, jy, 5, 6, weights=jw)
        press, se = jselect.cv_scores(jf, normalized=True)
        press, se = np.asarray(press), np.asarray(se)
    tf = select.fold_moments(_t(x, npd), _t(y, npd), 5, 6,
                             weights=_t(w, npd))
    assert tf.gram.shape == (5, 2, 3, 7, 7) and tf.count.shape == (5, 2, 3)
    for f in interop.MOMENT_FIELDS:
        _close(getattr(tf, f), np.asarray(getattr(jf, f)), npd, atol=1e-4)
    tp, tse = select.cv_scores(tf, normalized=True)
    assert tp.shape == (2, 3, 7) and tse.shape == (2, 3, 7)
    _close(tp, press, npd)
    np.testing.assert_allclose(tse.double().numpy(), se,
                               rtol=50 * RTOL[npd], atol=1e-6 * se.max())


@pytest.mark.parametrize("npd", DTYPES)
def test_fold_sums_equal_the_total_and_complements(npd):
    x, y = _planted(6, 2, (4, 101))
    tx, ty = _t(x, npd), _t(y, npd)
    folds = select.fold_moments(tx, ty, 4, 4)
    total = select.sum_folds(folds)
    direct = core.gram_moments(tx, ty, 4, weights=torch.ones_like(tx))
    for f in interop.MOMENT_FIELDS:
        np.testing.assert_allclose(getattr(total, f).double().numpy(),
                                   getattr(direct, f).double().numpy(),
                                   rtol=10 * RTOL[npd], atol=1e-4)
    np.testing.assert_array_equal(total.count.numpy(), np.full(4, 101.0))
    comp = select.complement_moments(folds)
    again = select.sum_folds(comp)
    np.testing.assert_allclose(again.gram.double().numpy(),
                               3 * total.gram.double().numpy(),
                               rtol=10 * RTOL[npd], atol=1e-3)
    with pytest.raises(ValueError):
        select.fold_moments(tx, ty, 1, 4)


# ------------------------------------------------------- entry points
@pytest.mark.parametrize("npd", DTYPES)
@pytest.mark.parametrize("folds,criterion", [(5, None), (0, None),
                                             (0, "bic"), (4, "gcv")])
def test_select_degree_against_reference(npd, folds, criterion):
    x, y = _planted(7 + folds, 3, (5, 400))
    with _x64(npd):
        js = jselect.select_degree(jnp.asarray(x, npd), jnp.asarray(y, npd),
                                   6, folds=folds, criterion=criterion)
        jbest = np.asarray(js.best_degree)
        jc = np.asarray(js.poly.coeffs)
        jscale = float(js.poly.domain_scale)
    engine.reset_moment_counter()
    ts = select.select_degree(x.astype(npd), y.astype(npd), 6, folds=folds,
                              criterion=criterion, device=CPU)
    assert engine.moment_counter()["calls"] == 1       # one data pass
    np.testing.assert_array_equal(ts.best_degree, jbest)
    assert ts.criterion == js.criterion
    # batched winners keep the zero-padded M+1 layout, zero past the winner
    assert ts.poly.coeffs.shape == (5, 7)
    for b, d in enumerate(ts.best_degree):
        assert np.abs(ts.poly.coeffs[b, d + 1:].numpy()).max(initial=0) == 0
    np.testing.assert_allclose(ts.poly.coeffs.double().numpy(), jc,
                               atol=ATOL[npd], rtol=0)
    np.testing.assert_allclose(float(ts.poly.domain_scale), jscale,
                               rtol=1e-6)
    assert ts.poly.diagnostics.condition.shape == (5,)


def test_select_degree_validation():
    x, y = _planted(9, 2, (60,))
    with pytest.raises(ValueError, match="folds >= 2"):
        select.select_degree(x, y, 4, folds=0, criterion="cv", device=CPU)
    with pytest.raises(ValueError):
        select.select_degree(x, y, 4, criterion="r2", device=CPU)


@pytest.mark.parametrize("npd", DTYPES)
def test_polyfit_auto_one_series_against_reference(npd):
    x, y = _planted(10, 4, (500,), snr=30.0)
    with _x64(npd):
        jp = jcore.polyfit(jnp.asarray(x, npd), jnp.asarray(y, npd), "auto")
        jc = np.asarray(jp.coeffs)
    tp = core.polyfit(x.astype(npd), y.astype(npd), "auto", device=CPU)
    assert tp.coeffs.shape == jc.shape          # sliced to the winner
    np.testing.assert_allclose(tp.coeffs.double().numpy(), jc,
                               atol=ATOL[npd], rtol=0)
    tq = core.polyfit(x.astype(npd), y.astype(npd),
                      select.DegreeSearch(max_degree=5, folds=0,
                                          criterion="aicc"), device=CPU)
    with _x64(npd):
        jq = jcore.polyfit(jnp.asarray(x, npd), jnp.asarray(y, npd),
                           jselect.DegreeSearch(max_degree=5, folds=0,
                                                criterion="aicc"))
    np.testing.assert_allclose(tq.coeffs.double().numpy(),
                               np.asarray(jq.coeffs), atol=ATOL[npd], rtol=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(ridge=1e-3), dict(domain=(0.0, 1.0)),
    dict(numerics=dict(normalize=True)), dict(decay=0.999),
    dict(method="irls")])
def test_api_fit_degree_search_against_reference(kw):
    """Batched (4, 300) series; the decay case runs one series, since the
    reference's fold pass cannot take its 1-D decay weights against a
    batch (ROADMAP Queue 3)."""
    kw = dict(kw)
    num = kw.pop("numerics", {})
    shape = (300,) if "decay" in kw else (4, 300)
    x, y = _planted(11, 3, shape)
    ds = dict(max_degree=6, folds=5)
    jspec = japi.FitSpec(degree=jselect.DegreeSearch(**ds),
                         numerics=japi.NumericsPolicy(solver="auto", **num),
                         **kw)
    with _x64(np.float64):
        jres = japi.fit(jnp.asarray(x), jnp.asarray(y), jspec)
        jbest = np.asarray(jres.best_degree)
        jc = np.asarray(jres.coeffs)
        jit = None if jres.iterations is None else int(jres.iterations)
    tspec = interop.fit_spec(jspec)
    assert tspec.is_search and tspec.max_degree == 6 and tspec.folds == 5
    tres = api.fit(x, y, tspec, device=CPU)
    np.testing.assert_array_equal(tres.best_degree, jbest)
    np.testing.assert_allclose(tres.coeffs.numpy(), jc, atol=1e-7, rtol=0)
    assert tres.selection.sweep.coeffs.shape == shape[:-1] + (7, 7)
    assert tres.report is None
    if jit is None:
        assert tres.iterations is None
    else:
        assert tres.iterations == jit
        assert bool(tres.converged.all())


def test_spec_search_validation_matches_reference():
    for kw in (dict(degree=select.DegreeSearch(max_degree=-1)),
               dict(degree=select.DegreeSearch(), method="lspia"),
               dict(degree=select.DegreeSearch(),
                    numerics=api.NumericsPolicy(solver="qr_vandermonde")),
               dict(degree="auto")):
        with pytest.raises(ValueError):
            api.FitSpec(**kw)
    spec = api.spec_from_legacy("auto")
    assert spec.is_search and spec.degree == select.DegreeSearch()
    assert api.FitSpec(degree=4).folds == 0
    with pytest.raises(ValueError):
        api.spec_from_legacy("best")


@pytest.mark.parametrize("pinned", [True, False])
def test_search_reads_the_data_domain_only_when_nothing_is_pinned(
        monkeypatch, pinned):
    """A normalized degree search calls ``Domain.from_data`` once on the
    data when nothing is pinned, and never when a domain is pinned (x is
    mapped by the pin and searched unnormalized); either way the winner's
    polynomial carries the domain it was fitted in."""
    from repro_torch.core import basis
    calls = []
    real = basis.Domain.from_data

    def spy(xin):
        calls.append(xin)
        return real(xin)

    monkeypatch.setattr(basis.Domain, "from_data", staticmethod(spy))
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.uniform(-3.0, 5.0, (2, 400)).astype(np.float32))
    y = 1.0 - 0.5 * x + 0.1 * x ** 3
    spec = api.FitSpec(degree=api.DegreeSearch(max_degree=4, folds=0),
                       numerics=api.NumericsPolicy(normalize=True),
                       domain=(0.5, 0.25) if pinned else None)
    res = api.fit(x, y, spec, device=CPU)
    if pinned:
        assert calls == []
        assert (float(res.poly.domain_shift),
                float(res.poly.domain_scale)) == (0.5, 0.25)
    else:
        assert len(calls) == 1 and calls[0] is x
        want = real(x)
        assert torch.equal(res.poly.domain_shift, want.shift)
        assert torch.equal(res.poly.domain_scale, want.scale)
