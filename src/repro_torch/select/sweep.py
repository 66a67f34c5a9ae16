"""Single-pass degree sweep: the whole ladder d = 0..M from ONE moment
accumulation (port of ``repro.select.sweep``).

The degree-M state holds every lower-degree state as a leading block
(``Moments.truncate``), so the one heavy step, the O(n·m²) moment pass, is
paid once at the maximum candidate degree and the selection runs on the
O(M²) sufficient statistics:

* ``solve_ladder``       one condition-aware ``solve_with_fallback`` per
                         rung, zero-padded into a (M+1, M+1) ladder;
* ``sweep_from_moments`` scores every rung (SSE, R², AIC, AICc, BIC, GCV,
                         and k-fold CV when fold partials are given);
* ``select_degree``      the one-pass entry point over raw data;
* ``DegreeSearch``       the hashable spec ``polyfit``/``FitSpec`` accept
                         as ``degree=``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import solve as solve_lib
from repro_torch.select import criteria


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Every degree's fit and score from one moment state.

    ``coeffs[..., d, :]`` is the degree-d solution zero-padded to M+1
    entries; ``condition`` / ``fallback_used`` are the per-rung solve
    diagnostics on the TRUNCATED Gram."""

    coeffs: torch.Tensor          # (..., M+1, M+1) zero-padded ladder
    condition: torch.Tensor       # (..., M+1) κ(truncated Gram) per degree
    fallback_used: torch.Tensor   # (..., M+1) bool
    scores: criteria.ScoreTable

    @property
    def max_degree(self) -> int:
        return self.coeffs.shape[-1] - 1

    def best(self, criterion: str = "aicc") -> torch.Tensor:
        return criteria.best_degree(self.scores, criterion)


@dataclasses.dataclass(frozen=True)
class DegreeSearch:
    """Hashable spec for ``polyfit(..., degree=DegreeSearch(...))``.

    ``degree="auto"`` is shorthand for ``DegreeSearch()``.  ``criterion``
    None resolves to "cv" when ``folds >= 2``, else "aicc"."""

    max_degree: int = 8
    folds: int = 5
    criterion: str | None = None
    solver: str = "auto"
    fallback: str | None = "svd"
    cond_cap: float | None = None


@dataclasses.dataclass(frozen=True)
class Selection:
    """Host-side result of a degree search.

    ``poly`` is the winning fit: for unbatched input its coefficients are
    sliced to the chosen degree; for batched input (per-series winners may
    differ) it keeps the zero-padded M+1 layout, which evaluates the
    same."""

    sweep: SweepResult
    best_degree: int | np.ndarray
    criterion: str
    poly: fit_lib.Polynomial


def solve_ladder(m: moments_lib.Moments, *, solver: str = "auto",
                 fallback: str | None = "svd",
                 cond_cap: float | None = None,
                 basis: str = basis_lib.MONOMIAL,
                 normalized: bool = False):
    """Solve all nested normal-equation systems d = 0..m.degree.

    Returns ``(coeffs, condition, fallback_used)`` with a ladder axis at
    -2 / -1.  ``solver="auto"`` re-picks the static rung per degree."""
    max_degree = m.degree
    coeffs, conds, used = [], [], []
    for d in range(max_degree + 1):
        mt = m.truncate(d)
        rung = (solve_lib.select_solver(d, m.gram.dtype, basis=basis,
                                        normalized=normalized)
                if solver == "auto" else solver)
        c, cond, fb = solve_lib.solve_with_fallback(
            mt.gram, mt.vty, method=rung, fallback=fallback,
            cond_cap=cond_cap)
        coeffs.append(torch.nn.functional.pad(c, (0, max_degree - d)))
        conds.append(cond)
        used.append(fb)
    return (torch.stack(coeffs, dim=-2), torch.stack(conds, dim=-1),
            torch.stack(used, dim=-1))


def sweep_from_moments(m: moments_lib.Moments, *,
                       fold_moments: moments_lib.Moments | None = None,
                       score_moments: moments_lib.Moments | None = None,
                       solver: str = "auto",
                       fallback: str | None = "svd",
                       cond_cap: float | None = None,
                       basis: str = basis_lib.MONOMIAL,
                       normalized: bool = False) -> SweepResult:
    """The full degree sweep from one degree-M moment state.

    ``fold_moments`` (leading fold axis) enables the "cv" column;
    ``score_moments`` scores on a state other than the one solved (the
    raw state when ``m`` carries a ridge), so SSEs are not inflated by
    λ‖a‖²."""
    coeffs, cond, fb = solve_ladder(m, solver=solver, fallback=fallback,
                                    cond_cap=cond_cap, basis=basis,
                                    normalized=normalized)
    ms = score_moments if score_moments is not None else m
    sse = fit_lib.sse_from_moments(ms, coeffs)
    sw = torch.clamp(ms.weight_sum, min=torch.finfo(ms.gram.dtype).tiny)
    sst = ms.yty - ms.vty[..., 0] ** 2 / sw
    cv = cv_se = None
    if fold_moments is not None:
        from repro_torch.select import crossval
        cv, cv_se = crossval.cv_scores(fold_moments, solver=solver,
                                       fallback=fallback, cond_cap=cond_cap,
                                       basis=basis, normalized=normalized)
    scores = criteria.score_table(sse, ms.count, sst, cv, cv_se)
    return SweepResult(coeffs=coeffs, condition=cond, fallback_used=fb,
                       scores=scores)


def selection_from_sweep(sweep: SweepResult, criterion: str, *,
                         domain: basis_lib.Domain | None = None,
                         basis: str = basis_lib.MONOMIAL,
                         solver: str = "auto",
                         fallback: str | None = "svd") -> Selection:
    """Pick the winner out of a sweep and package it as a ``Polynomial``
    (reads the winning degree back to the host).  Batched sweeps keep the
    zero-padded layout with per-series winners gathered along the ladder
    axis."""
    best = sweep.best(criterion)
    dom = domain or basis_lib.Domain.identity(sweep.coeffs.dtype,
                                              sweep.coeffs.device)
    if best.ndim == 0:
        b = int(best)
        coeffs = sweep.coeffs[..., b, :b + 1]
        cond = sweep.condition[..., b]
        fb = sweep.fallback_used[..., b]
        best_out: int | np.ndarray = b
    else:
        idx = best.long()
        coeffs = torch.take_along_dim(
            sweep.coeffs, idx[..., None, None], dim=-2)[..., 0, :]
        cond = torch.take_along_dim(sweep.condition, idx[..., None],
                                    dim=-1)[..., 0]
        fb = torch.take_along_dim(sweep.fallback_used, idx[..., None],
                                  dim=-1)[..., 0]
        best_out = best.cpu().numpy()
    diag = fit_lib.FitDiagnostics(condition=cond, fallback_used=fb,
                                  solver=solver, fallback=fallback or "none")
    poly = fit_lib.Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                              domain_scale=dom.scale, basis=basis,
                              diagnostics=diag)
    return Selection(sweep=sweep, best_degree=best_out, criterion=criterion,
                     poly=poly)


def select_degree(x, y, max_degree: int = 8, *, folds: int = 5,
                  criterion: str | None = None, weights=None,
                  basis: str = basis_lib.MONOMIAL,
                  normalize: bool | None = None, engine: str = "auto",
                  solver: str = "auto", fallback: str | None = "svd",
                  cond_cap: float | None = None, accum_dtype: Any = None,
                  ridge: float = 0.0, device=None) -> Selection:
    """Pick the polynomial degree from ONE pass over the data.

    One degree-``max_degree`` moment accumulation (k-fold partials when
    ``folds >= 2``, round-robin, every point touched once) feeds the whole
    ladder.  The plan layer (``workload="select"``) routes it like a fit:
    on CUDA the packed kernel takes the fold axis as a series batch.
    ``criterion`` defaults to "cv" (with folds) / "aicc" (without);
    ``normalize=None`` lets the numerics policy decide at ``max_degree``.
    ``ridge`` adds λI to the ladder SOLVES while the scores stay on the
    raw state.  ``device=None`` means CUDA."""
    from repro_torch import engine as engine_lib
    from repro_torch.device import as_tensor, resolve_device
    from repro_torch.select import crossval
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    folds = int(folds)
    if criterion is None:
        criterion = "cv" if folds >= 2 else "aicc"
    if criterion == "cv" and folds < 2:
        raise ValueError("criterion='cv' needs folds >= 2")
    if criterion not in criteria.CRITERIA:
        raise ValueError(f"criterion={criterion!r}; expected one of "
                         f"{criteria.CRITERIA}")

    batch = tuple(x.shape[:-1])
    if folds >= 2:
        plan_shape = (folds,) + batch + (-(-x.shape[-1] // folds),)
    else:
        plan_shape = tuple(x.shape)
    plan = engine_lib.plan_fit(
        plan_shape, max_degree, basis=basis, dtype=x.dtype,
        weighted=folds >= 2 or weights is not None, engine=engine,
        accum_dtype=accum_dtype, normalize=bool(normalize or False),
        solver=solver, fallback=fallback, cond_cap=cond_cap, device=dev,
        workload="select")
    do_norm = plan.numerics.normalize if normalize is None else bool(normalize)
    dom = basis_lib.Domain.choose(x, normalize=do_norm)
    xt = dom.apply(x)

    if folds >= 2:
        fold_m = crossval.fold_moments(xt, y, folds, max_degree,
                                       weights=weights, basis=basis,
                                       plan=plan)
        total = crossval.sum_folds(fold_m)
    else:
        fold_m = None
        total = engine_lib.compute_moments(plan, xt, y, weights)

    solve_m, score_m = total, None
    if ridge:
        solve_m, score_m = total.regularized(ridge), total
    sweep = sweep_from_moments(solve_m, fold_moments=fold_m,
                               score_moments=score_m, solver=solver,
                               fallback=fallback, cond_cap=cond_cap,
                               basis=basis, normalized=do_norm)
    return selection_from_sweep(sweep, criterion, domain=dom, basis=basis,
                                solver=solver, fallback=fallback)
