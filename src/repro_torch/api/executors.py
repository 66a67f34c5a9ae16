"""The executors consuming one ``FitSpec`` (port of
``repro.api.executors``):

* ``fit(x, y, spec)``       eager, any spec;
* ``stream_state(spec)``    (= ``spec.streaming()``) an O(1)-state
                            ``StreamState`` + ``stream_result``;
* ``make_distributed(spec, mesh)``  (= ``spec.distributed(mesh)``) the
                            mesh executor over ``torch.distributed``;
* the fit server's ``submit(x, y, spec=...)`` (``serve.fit_engine``).

Each lowers through ``engine.plan_fit`` (via ``FitSpec.plan``), so path
and numerics selection stay in one place."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import engine as engine_lib
from repro_torch import select as select_lib
from repro_torch.api.spec import FitResult, FitSpec, RAW_DATA_SOLVERS
from repro_torch.core import basis as basis_lib
from repro_torch.core import distributed as distributed_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import lspia as lspia_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import robust as robust_lib
from repro_torch.core import solve as solve_lib
from repro_torch.core import streaming as streaming_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.engine import plan as plan_lib
from repro_torch.obs import spans


def spec_from_legacy(degree, *, method: str | None = None,
                     basis: str = basis_lib.MONOMIAL,
                     normalize: bool = False, accum_dtype=None,
                     engine: str = "auto", solver: str = "auto",
                     fallback: str | None = "svd",
                     cond_cap: float | None = None,
                     decay: float = 1.0, ridge: float = 0.0) -> FitSpec:
    """Map the legacy ``polyfit``-style kwargs onto a ``FitSpec``
    (``method=`` is the legacy spelling of ``solver=``)."""
    if isinstance(degree, str):
        if degree != "auto":
            raise ValueError(f"degree={degree!r}; expected an int, 'auto', "
                             "or a DegreeSearch")
        degree = select_lib.DegreeSearch()
    if method is not None:
        solver = method
    meth = "lse"
    if solver == "lspia":
        meth, solver, normalize = "lspia", "auto", True
    return FitSpec(
        degree=degree, basis=basis, method=meth,
        numerics=plan_lib.NumericsPolicy(accum_dtype=accum_dtype,
                                         normalize=normalize, solver=solver,
                                         fallback=fallback,
                                         cond_cap=cond_cap),
        decay=decay, ridge=ridge, engine=engine)


def _decay_weights(x: torch.Tensor, weights, decay: float):
    """The spec's γ-ladder folded into the weights (None when neither)."""
    if decay >= 1.0:
        return weights
    lad = moments_lib.decay_ladder(x.shape[-1], decay, x.dtype, x.device)
    return lad if weights is None else weights * lad


def _fit_lse_fixed(x: torch.Tensor, y: torch.Tensor,
                   weights: torch.Tensor | None, spec: FitSpec):
    """The paper's pipeline for one fixed-degree LSE spec: plan → domain →
    moments → condition-aware solve (+ the free moment-space report)."""
    degree = int(spec.degree)
    w = _decay_weights(x, weights, spec.decay)
    if spec.numerics.solver in RAW_DATA_SOLVERS:
        # the MATLAB-polyfit baseline: QR directly on the (weighted)
        # Vandermonde rows — no moments, no squaring of κ
        dom = basis_lib.Domain.choose(
            x, normalize=spec.numerics.normalize,
            pinned=spec.domain_or(dtype=x.dtype, device=x.device))
        v = basis_lib.vandermonde(dom.apply(x), degree, spec.basis)
        yy = y
        if w is not None:
            sw = torch.sqrt(w)
            v = v * sw[..., :, None]
            yy = y * sw
        coeffs = solve_lib.qr_solve_vandermonde(v, yy)
        poly = fit_lib.Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                                  domain_scale=dom.scale, basis=spec.basis)
        return poly, None
    plan = spec.plan(tuple(x.shape), x.dtype, weighted=weights is not None,
                     device=x.device)
    pol = plan.numerics
    with spans.span("fit.domain"):
        dom = basis_lib.Domain.choose(
            x, normalize=pol.normalize,
            pinned=spec.domain_or(dtype=x.dtype, device=x.device))
    # x stays raw: the moment pass maps it as it reads it
    m = engine_lib.compute_moments(plan, x, y, w, domain=dom)
    ms = m.regularized(spec.ridge) if spec.ridge else m
    poly = fit_lib.fit_from_moments(
        ms, solver=pol.solver, fallback=pol.fallback, cond_cap=pol.cond_cap,
        domain=dom, basis=spec.basis,
        normalized=pol.normalize or spec.domain is not None)
    return poly, fit_lib.report_from_moments(m, poly.coeffs)


def _fit_search(x: torch.Tensor, y: torch.Tensor,
                weights: torch.Tensor | None, spec: FitSpec) -> FitResult:
    """DegreeSearch specs: one-pass selection (the winning degree is read
    back to slice the coefficients).  Under ``method="irls"`` the robust
    weights come first, from IRLS at the max candidate degree, and the
    one-pass weighted ladder rides on them."""
    ds = spec.degree
    iterations = converged = None
    weights = _decay_weights(x, weights, spec.decay)
    if spec.method == "irls":
        fixed = dataclasses.replace(spec, degree=ds.max_degree, decay=1.0)
        rfit, weights = robust_lib.irls_fit(x, y, weights, fixed)
        iterations, converged = rfit.iterations, rfit.converged
    pol = spec.numerics
    solver = pol.solver if pol.solver != "auto" else ds.solver
    dom = spec.domain_or(None, dtype=x.dtype, device=x.device)
    if dom is not None:
        xs = dom.apply(x)
        normalize_arg: bool | None = False
    else:
        xs = x
        normalize_arg = True if pol.normalize else None
    sel = select_lib.select_degree(
        xs, y, ds.max_degree, folds=ds.folds, criterion=ds.criterion,
        weights=weights, basis=spec.basis, normalize=normalize_arg,
        engine=spec.engine, solver=solver, fallback=ds.fallback,
        cond_cap=ds.cond_cap, accum_dtype=pol.accum_dtype,
        ridge=spec.ridge, device=x.device)
    poly = sel.poly
    if dom is not None:
        poly = dataclasses.replace(poly, domain_shift=dom.shift,
                                   domain_scale=dom.scale)
        sel = dataclasses.replace(sel, poly=poly)
    return FitResult(poly=poly, selection=sel, iterations=iterations,
                     converged=converged)


@spans.span("api.fit")
def fit(x, y, spec: FitSpec | None = None, *, weights=None,
        device=None) -> FitResult:
    """Executor 1: one eager call, any spec.  ``device=None`` means CUDA
    (raises without it); the tests pass ``device="cpu"``."""
    spec = FitSpec() if spec is None else spec
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    if spec.is_search:
        return _fit_search(x, y, weights, spec)
    if spec.method == "irls":
        rfit, _ = robust_lib.irls_fit(x, y, weights, spec)
        return FitResult(poly=rfit.poly, iterations=rfit.iterations,
                         converged=rfit.converged)
    if spec.method == "lspia":
        lf = lspia_lib.lspia_fit_spec(x, y, weights, None, spec)
        return FitResult(poly=lf.poly, iterations=lf.iterations,
                         converged=lf.converged)
    poly, rep = _fit_lse_fixed(x, y, weights, spec)
    return FitResult(poly=poly, report=rep)


# ------------------------------------------------------------ streaming
@spans.span("stream.state")
def stream_state(spec: FitSpec, batch: tuple[int, ...] = (), *,
                 dtype=None, device=None) -> streaming_lib.StreamState:
    """Executor 2 state: an O(1) ``StreamState`` wired to the spec, on
    ``device`` (``None`` means CUDA).

    The accumulation degree is the spec's max degree (a DegreeSearch's
    ladder nests inside it) and a DegreeSearch's ``folds`` become
    chunk-round-robin CV partials.  A domain-normalizing spec must PIN the
    domain (``FitSpec(domain=(shift, scale))``): a stream cannot derive
    min/max from data it has not seen yet."""
    if spec.numerics.solver in RAW_DATA_SOLVERS:
        raise ValueError(
            f"solver={spec.numerics.solver!r} needs the raw Vandermonde "
            "rows; the streaming surface only holds moments")
    dev = resolve_device(device)
    dtype = dtype or spec.numerics.accum_dtype or torch.float32
    pol = spec.plan((8,), dtype, weighted=True, device=dev).numerics
    if pol.normalize and spec.domain is None:
        raise ValueError(
            "this spec normalizes the domain (explicitly or by the "
            "numerics policy's high-degree escalation), but a stream "
            "cannot derive min/max from unseen data — pin it with "
            "FitSpec(domain=(shift, scale))")
    return streaming_lib.StreamState.create(
        spec.max_degree, batch, decay=spec.decay, dtype=dtype,
        cv_folds=spec.folds, spec=spec, device=dev)


@spans.span("stream.result")
def stream_result(state: streaming_lib.StreamState) -> FitResult:
    """Read the spec's answer out of a running stream state: fixed-degree
    solve, moment-space LSPIA, or the scored degree ladder, all O(m²)
    work on the sufficient statistics, zero re-reads of the stream."""
    spec = state.spec
    if spec is None or (not spec.is_search and spec.method != "lspia"):
        poly = streaming_lib.current_fit(state)
        return FitResult(poly=poly, report=fit_lib.report_from_moments(
            state.moments, poly.coeffs))
    dtype = state.moments.gram.dtype
    if spec.is_search:
        m = (state.moments.regularized(spec.ridge) if spec.ridge
             else state.moments)
        ds = spec.degree
        criterion = ds.criterion
        if criterion is None:
            criterion = "cv" if state.fold_moments is not None else "aicc"
        if criterion == "cv" and state.fold_moments is None:
            raise ValueError("criterion='cv' needs fold partials; create "
                             "the state via spec.streaming() with "
                             "DegreeSearch(folds >= 2)")
        solver = (spec.numerics.solver if spec.numerics.solver != "auto"
                  else ds.solver)
        sweep = select_lib.sweep_from_moments(
            m, fold_moments=state.fold_moments,
            score_moments=state.moments if spec.ridge else None,
            solver=solver, fallback=ds.fallback, cond_cap=ds.cond_cap,
            basis=spec.basis, normalized=spec.domain is not None)
        dom = spec.domain_or(None, dtype=dtype, device=state.device)
        sel = select_lib.selection_from_sweep(
            sweep, criterion, domain=dom, basis=spec.basis, solver=solver,
            fallback=ds.fallback)
        # score the winner in its zero-padded ladder layout (the sliced
        # poly.coeffs would not broadcast against the full-width state)
        best = torch.as_tensor(sel.best_degree, device=state.device)
        if best.ndim == 0:
            padded = sweep.coeffs[..., int(best), :]
        else:
            padded = torch.take_along_dim(
                sweep.coeffs, best.long()[..., None, None], dim=-2)[..., 0, :]
        return FitResult(poly=sel.poly, selection=sel,
                         report=fit_lib.report_from_moments(state.moments,
                                                            padded))
    # moment-space LSPIA: Richardson on the accumulated normal equations
    coeffs, cond, conv, it = lspia_lib.lspia_solve_spec(state.moments, spec)
    diag = fit_lib.FitDiagnostics(condition=cond, fallback_used=~conv,
                                  solver="lspia", fallback="none")
    dom = spec.domain_or(basis_lib.Domain.identity(dtype, state.device),
                         dtype=dtype, device=state.device)
    poly = fit_lib.Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                              domain_scale=dom.scale, basis=spec.basis,
                              diagnostics=diag)
    return FitResult(poly=poly,
                     report=fit_lib.report_from_moments(state.moments,
                                                        coeffs),
                     iterations=it, converged=conv)


# ---------------------------------------------------------- distributed
def make_distributed(spec: FitSpec, mesh, *,
                     data_axes: tuple[str, ...] = ("data",)):
    """Executor 3: ``fn(x, y, weights=None) -> FitResult`` on a
    ``DeviceMesh``.

    Every rank calls ``fn`` with its own block of the series, laid out
    row-major over ``data_axes`` (``core.distributed``'s input contract);
    the result is replicated.  The method dispatch, the O(m²)
    all-reduce, IRLS with an all-reduce per sweep, moment-space LSPIA and
    the fold-stack all-reduce of a DegreeSearch live in
    ``core.distributed.make_spec_executor``.  Each call is one
    ``api.distributed`` span (``obs.spans``), holding ``fit.domain`` (the
    global domain; for IRLS, LSPIA and a degree search a second one holds
    the map of x, which a plain LSE fit's moment kernel does as it loads
    x) and a ``mesh.allreduce`` a collective."""
    runner, kind = distributed_lib.make_spec_executor(
        spec, mesh, data_axes=data_axes)
    if spec.is_search:
        ds = spec.degree
        criterion = ds.criterion or ("cv" if ds.folds >= 2 else "aicc")

    @spans.span("api.distributed")
    def run(x, y, weights=None) -> FitResult:
        out = runner(x, y, weights)
        if kind == "search":
            poly, sweep, best = out
            best_np = best.cpu().numpy()
            sel = select_lib.Selection(
                sweep=sweep,
                best_degree=(int(best_np) if best_np.ndim == 0 else best_np),
                criterion=criterion, poly=poly)
            return FitResult(poly=poly, selection=sel)
        if kind == "iter":
            poly, m, it, conv = out
            return FitResult(poly=poly,
                             report=fit_lib.report_from_moments(
                                 m, poly.coeffs),
                             iterations=it, converged=conv)
        poly, m = out
        return FitResult(poly=poly,
                         report=fit_lib.report_from_moments(m, poly.coeffs))

    return run
