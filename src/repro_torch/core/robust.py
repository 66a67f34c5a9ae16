"""Robust polynomial fitting: IRLS with Huber/Tukey weights (port of
``repro.core.robust``).

Each IRLS iteration is exactly the paper's matricized weighted fit:
moments with per-point weights through ``engine.compute_moments`` (the
packed CUDA kernel for a batch on the card), then the condition-aware
solve, with the weights recomputed from the standardized residuals.
Robustness costs ``iterations`` more moment passes and nothing else.

Weights (ψ(u)/u form, u = r/σ̂, σ̂ = 1.4826·MAD):

* ``huber``:  w = 1 for |u| ≤ c, c/|u| beyond; c = 1.345;
* ``tukey``:  w = (1 − (u/c)²)² inside |u| < c, 0 beyond; c = 4.685.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import solve as solve_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.obs import spans

HUBER = "huber"
TUKEY = "tukey"
# 95% asymptotic Gaussian efficiency tunings (Huber 1981; Beaton-Tukey)
DEFAULT_TUNING = {HUBER: 1.345, TUKEY: 4.685}
# loss ids for callers that pick the loss per series from a tensor
LOSS_IDS = {HUBER: 0, TUKEY: 1}


@dataclasses.dataclass(frozen=True)
class RobustFit:
    """An IRLS fit: the polynomial plus the iteration's own diagnostics."""

    poly: fit_lib.Polynomial
    iterations: int              # IRLS iterations run (after the LSE start)
    converged: torch.Tensor      # (...,) coefficient change fell below tol
    scale: torch.Tensor          # (...,) final robust σ̂ (1.4826·MAD)


def resolve_tuning(loss: str, c: float | None) -> float:
    """The ψ tuning constant: the 95%-efficiency default unless forced."""
    if loss not in DEFAULT_TUNING:
        raise ValueError(f"unknown loss {loss!r}; expected {HUBER!r} or "
                         f"{TUKEY!r}")
    return float(DEFAULT_TUNING[loss] if c is None else c)


def _huber(u, c):
    au = torch.abs(u)
    return torch.where(au <= c, torch.ones_like(u), c / torch.clamp(au, min=c))


def _tukey(u, c):
    t = (u / c) ** 2
    return torch.where(t < 1.0, (1.0 - t) ** 2, torch.zeros_like(u))


def robust_weights(u: torch.Tensor, loss: str, c: float) -> torch.Tensor:
    """ψ(u)/u weights of standardized residuals u for a loss name."""
    if loss == HUBER:
        return _huber(u, c)
    if loss == TUKEY:
        return _tukey(u, c)
    raise ValueError(f"unknown loss {loss!r}; expected {HUBER!r} or {TUKEY!r}")


def robust_weights_by_id(u: torch.Tensor, loss_id: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """``robust_weights`` with the loss picked per series by a tensor of
    ``LOSS_IDS`` and a per-series tuning ``c``: both forms are computed
    and selected."""
    huber = _huber(u, c)
    tukey = _tukey(u, torch.clamp(c, min=torch.finfo(u.dtype).tiny))
    return torch.where(loss_id == LOSS_IDS[TUKEY], tukey, huber)


def _nanmedian(a: torch.Tensor) -> torch.Tensor:
    """Median over the last axis ignoring NaNs, keeping the axis: the MEAN
    of the two middle values for an even count, as ``jnp.nanmedian`` (and
    not ``torch.nanmedian``, which returns the lower one); NaN where every
    value is NaN.  A sort along the last axis (NaNs sort last) and a
    gather of the two middle positions per row: ``torch.nanquantile``
    refuses inputs beyond 2²⁴ elements."""
    s = torch.sort(a, dim=-1).values
    count = torch.sum(~torch.isnan(a), dim=-1, keepdim=True)
    lo = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(count, 2, rounding_mode="floor"),
                     max=a.shape[-1] - 1)
    hi = torch.where(count > 0, hi, lo)
    return (0.5 * torch.take_along_dim(s, lo, dim=-1)
            + 0.5 * torch.take_along_dim(s, hi, dim=-1))


@spans.span("irls.scale")
def chunk_scale(r: torch.Tensor, base_w: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """Robust σ̂ (1.4826·MAD, floored) of one chunk of residuals, (..., 1).

    Zero-weight points are excluded, all-masked series pin σ̂ to the
    floor, and the floor keeps u = r/σ̂ finite on near-exact fits."""
    eps = torch.finfo(r.dtype).eps
    nan = torch.tensor(float("nan"), dtype=r.dtype, device=r.device)
    live = base_w > 0
    has_pts = torch.any(live, dim=-1, keepdim=True)
    y_med = _nanmedian(torch.where(live, torch.abs(y), nan))
    floor = eps * (1.0 + torch.where(has_pts, y_med, torch.zeros_like(y_med)))
    mad = _nanmedian(torch.where(live, torch.abs(r), nan))
    mad = torch.where(has_pts, mad, torch.zeros_like(mad))
    return torch.maximum(1.4826 * mad, floor)


@spans.span("irls.converge")
def still_moving(delta: torch.Tensor, tol: float) -> bool:
    """Whether any series' coefficient change exceeds ``tol``: the IRLS
    loop's one read back to the host a sweep, which drains the queue."""
    return bool(torch.any(delta > tol))


def irls_fit(x: torch.Tensor, y: torch.Tensor,
             weights: torch.Tensor | None, spec):
    """The IRLS engine, keyed on a ``FitSpec`` (method="irls").

    Returns ``(RobustFit, final_weights)``: the converged ψ-weights times
    the base weights, which a DegreeSearch under robust loss feeds into
    its weighted ladder.  Every iteration is one weighted moment pass (the
    same plan as any weighted LSE fit) and one condition-aware solve; the
    loop reads ``any(delta > tol)`` back once per iteration
    (``still_moving``).  Phase spans: ``irls.sweep`` each iteration,
    ``irls.scale`` each MAD scale (``chunk_scale``), ``irls.weights`` the
    residuals and the ψ weights, ``irls.converge`` each stop test."""
    from repro_torch import engine as engine_lib
    opts = spec.irls
    loss = opts.loss
    cval = resolve_tuning(loss, opts.c)
    plan = spec.plan(tuple(x.shape), x.dtype, weighted=True,
                     device=x.device)
    pol = plan.numerics
    dom = basis_lib.Domain.choose(
        x, normalize=pol.normalize,
        pinned=spec.domain_or(dtype=x.dtype, device=x.device))
    xt = dom.apply(x)
    base_w = torch.ones_like(x) if weights is None else weights
    if spec.decay < 1.0:
        from repro_torch.core import moments as moments_lib
        base_w = base_w * moments_lib.decay_ladder(
            x.shape[-1], spec.decay, x.dtype, x.device)

    def fit_with(w):
        m = engine_lib.compute_moments(plan, xt, y, w)
        if spec.ridge:
            m = m.regularized(spec.ridge)
        return solve_lib.solve_with_fallback(
            m.gram, m.vty, method=pol.solver, fallback=pol.fallback,
            cond_cap=pol.cond_cap)

    def sigma_of(coeffs):
        with spans.span("irls.weights"):
            r = y - basis_lib.evaluate(coeffs, xt, basis=spec.basis)
        return r, chunk_scale(r, base_w, y)

    def psi_weights(r, sigma):
        with spans.span("irls.weights"):
            return robust_weights(r / sigma, loss, cval) * base_w

    coeffs, cond, used = fit_with(base_w)
    # near-exact fits jitter at ~100s of ulps as the weights flip on
    # roundoff: keep tol above that floor or clean data spins to max_iter
    tol = max(float(opts.tol), 500.0 * float(torch.finfo(x.dtype).eps))
    delta = torch.full(tuple(x.shape[:-1]), float("inf"), dtype=x.dtype,
                       device=x.device)
    it = 0
    while it < opts.max_iter and still_moving(delta, tol):
        with spans.span("irls.sweep"):
            r, sigma = sigma_of(coeffs)
            new, cond, used = fit_with(psi_weights(r, sigma))
            scale = torch.clamp(torch.amax(torch.abs(new), dim=-1), min=1.0)
            delta = torch.amax(torch.abs(new - coeffs), dim=-1) / scale
            coeffs = new
            it += 1
    r, sigma = sigma_of(coeffs)
    final_w = psi_weights(r, sigma)
    diag = fit_lib.FitDiagnostics(condition=cond, fallback_used=used,
                                  solver=pol.solver,
                                  fallback=pol.fallback or "none")
    poly = fit_lib.Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                              domain_scale=dom.scale, basis=spec.basis,
                              diagnostics=diag)
    rfit = RobustFit(poly=poly, iterations=it, converged=delta <= tol,
                     scale=sigma[..., 0])
    return rfit, final_w


def robust_polyfit(x, y, degree: int, *, weights=None, loss: str = HUBER,
                   c: float | None = None, max_iter: int = 30,
                   tol: float = 1e-6, basis: str = basis_lib.MONOMIAL,
                   normalize: bool = False, accum_dtype=None,
                   engine: str = "auto", solver: str = "auto",
                   fallback: str | None = "svd", device=None) -> RobustFit:
    """IRLS M-estimator fit, the robust sibling of ``core.polyfit``: a
    shim that builds ``FitSpec(method="irls")`` and runs ``irls_fit``.
    ``weights`` are base weights; zero-weight points are left out of the
    MAD scale.  ``device=None`` means CUDA."""
    from repro_torch.api import spec as spec_lib
    from repro_torch.engine import plan as plan_lib
    resolve_tuning(loss, c)
    spec = spec_lib.FitSpec(
        degree=int(degree), basis=basis, method="irls",
        irls=spec_lib.IRLSOptions(loss=loss, c=c, max_iter=int(max_iter),
                                  tol=float(tol)),
        numerics=plan_lib.NumericsPolicy(accum_dtype=accum_dtype,
                                         normalize=normalize, solver=solver,
                                         fallback=fallback),
        engine=engine)
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    rfit, _ = irls_fit(x, y, weights, spec)
    return rfit
