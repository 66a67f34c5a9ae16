"""The eager executor consuming one ``FitSpec`` (port of the eager half of
``repro.api.executors``).  It lowers through ``engine.plan_fit`` via
``FitSpec.plan``, so path and numerics selection stay in one place."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import engine as engine_lib
from repro_torch import select as select_lib
from repro_torch.api.spec import FitResult, FitSpec, RAW_DATA_SOLVERS
from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import robust as robust_lib
from repro_torch.core import solve as solve_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.engine import plan as plan_lib


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


def _spec_domain(spec: FitSpec, x: torch.Tensor,
                 normalize: bool) -> basis_lib.Domain:
    default = (basis_lib.Domain.from_data(x) if normalize
               else basis_lib.Domain.identity(x.dtype, x.device))
    return spec.domain_or(default, dtype=x.dtype, device=x.device)


def _fit_lse_fixed(x: torch.Tensor, y: torch.Tensor,
                   weights: torch.Tensor | None, spec: FitSpec):
    """The paper's pipeline for one fixed-degree LSE spec: plan → domain →
    moments → condition-aware solve (+ the free moment-space report)."""
    degree = int(spec.degree)
    w = _decay_weights(x, weights, spec.decay)
    if spec.numerics.solver in RAW_DATA_SOLVERS:
        # the MATLAB-polyfit baseline: QR directly on the (weighted)
        # Vandermonde rows — no moments, no squaring of κ
        dom = _spec_domain(spec, x, spec.numerics.normalize)
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
    dom = _spec_domain(spec, x, pol.normalize)
    m = engine_lib.compute_moments(plan, dom.apply(x), y, w)
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


def fit(x, y, spec: FitSpec | None = None, *, weights=None,
        device=None) -> FitResult:
    """Executor 1: one eager call, any spec but LSPIA's.  ``device=None``
    means CUDA (raises without it); the tests pass ``device="cpu"``."""
    spec = FitSpec() if spec is None else spec
    if spec.method == "lspia":
        raise NotImplementedError(
            "method='lspia' is not ported yet: ROADMAP Queue 1 item 8 "
            "(core/lspia.py)")
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
    poly, rep = _fit_lse_fixed(x, y, weights, spec)
    return FitResult(poly=poly, report=rep)
