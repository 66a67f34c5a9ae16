"""Public curve-fitting API: the paper's algorithm end to end (port of
``repro.core.fit``).

``polyfit(x, y, degree)`` runs the paper's pipeline — matricized moments
(VᵀV, Vᵀy) → condition-aware solve → coefficients.  ``polyfit_qr`` is the
MATLAB-polyfit baseline; ``fit_report`` / ``fit_report_streamed`` compute
the paper's accuracy artifacts (Σe², correlation coefficient R).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import solve as solve_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.obs import spans


@dataclasses.dataclass(frozen=True)
class FitDiagnostics:
    """Numerical health of one normal-equation solve: the estimated κ₂ of
    the Gram (+inf when singular) and whether the rescue solver produced
    the returned coefficients.  On CUDA the ``gauss`` rung of k <= 8 runs
    in the solve kernel, which estimates κ in float64 for a float32 Gram
    too: there ``condition`` can differ from the CPU's float32 estimate,
    and past the cap so can ``fallback_used`` (the card rescues series
    whose float64 κ exceeds it)."""

    condition: torch.Tensor       # (...,) estimated κ₂(VᵀV)
    fallback_used: torch.Tensor   # (...,) bool
    solver: str = "gauss"
    fallback: str = "none"


@dataclasses.dataclass(frozen=True)
class Polynomial:
    """A fitted polynomial: coefficients + the basis/domain they live in."""

    coeffs: torch.Tensor                   # (..., m+1)
    domain_shift: torch.Tensor             # scalar (0 for paper-faithful)
    domain_scale: torch.Tensor             # scalar (1 for paper-faithful)
    basis: str = basis_lib.MONOMIAL
    diagnostics: FitDiagnostics | None = None

    @property
    def degree(self) -> int:
        return self.coeffs.shape[-1] - 1

    @property
    def domain(self) -> basis_lib.Domain:
        return basis_lib.Domain(self.domain_shift, self.domain_scale)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return basis_lib.evaluate(self.coeffs, x, basis=self.basis,
                                  domain=self.domain)

    def monomial_coeffs(self) -> torch.Tensor:
        """Raw-x monomial coefficients (for comparing against the paper)."""
        if self.basis != basis_lib.MONOMIAL:
            raise NotImplementedError("convert chebyshev via numpy.polynomial")
        return basis_lib.monomial_coeffs_from_domain(
            self.coeffs, self.domain, self.degree)


@spans.span("fit.solve")
def fit_from_moments(m: moments_lib.Moments, *, method: str | None = None,
                     solver: str = "auto",
                     fallback: str | None = "svd",
                     cond_cap: float | None = None,
                     domain: basis_lib.Domain | None = None,
                     basis: str = basis_lib.MONOMIAL,
                     normalized: bool = False) -> Polynomial:
    """Solve the normal equations held in ``m`` (the tiny-solve half of the
    paper's algorithm).  ``solver="auto"`` picks the static rung; unless
    ``fallback=None`` the runtime condition estimate swaps in the rescue
    past ``cond_cap`` or on non-finite output."""
    if method is not None:
        solver = method
    if solver == "lspia":
        raise ValueError(
            "solver='lspia' needs the raw data (matrix-free V/Vᵀ sweeps) "
            "and cannot run from moments")
    if solver == "qr_vandermonde":
        raise ValueError(
            "solver='qr_vandermonde' factors the raw Vandermonde rows and "
            "cannot run from moments; use core.polyfit(..., "
            "solver='qr_vandermonde') (the eager surface holds the data)")
    if solver == "auto":
        solver = solve_lib.select_solver(m.degree, m.gram.dtype, basis=basis,
                                         normalized=normalized)
    coeffs, cond, used = solve_lib.solve_with_fallback(
        m.gram, m.vty, method=solver, fallback=fallback, cond_cap=cond_cap)
    diag = FitDiagnostics(condition=cond, fallback_used=used, solver=solver,
                          fallback=fallback or "none")
    dom = domain or basis_lib.Domain.identity(coeffs.dtype, coeffs.device)
    return Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                      domain_scale=dom.scale, basis=basis, diagnostics=diag)


def polyfit(x, y, degree, *, weights=None,
            method: str | None = None, basis: str = basis_lib.MONOMIAL,
            normalize: bool = False, accum_dtype=None,
            engine: str = "auto",
            solver: str = "auto",
            fallback: str | None = "svd",
            cond_cap: float | None = None,
            use_kernel: bool | None = None,
            device=None) -> Polynomial:
    """The paper's pipeline; a shim over ``api.fit``.  ``degree="auto"``
    or ``degree=DegreeSearch(...)`` picks the degree from the same single
    moment pass (``select/``).  ``use_kernel`` is a deprecated alias of
    ``engine=``.  ``device=None`` means CUDA; pass ``device="cpu"`` for
    the plain PyTorch path."""
    from repro_torch import api
    from repro_torch import engine as engine_lib
    spec = api.spec_from_legacy(
        degree, method=method, basis=basis, normalize=normalize,
        accum_dtype=accum_dtype,
        engine=engine_lib.resolve_engine(engine, use_kernel),
        solver=solver, fallback=fallback, cond_cap=cond_cap)
    return api.fit(x, y, spec, weights=weights, device=device).poly


def polyfit_qr(x, y, degree: int, *, device=None) -> Polynomial:
    """Deprecated: the MATLAB-polyfit baseline (QR on the Vandermonde);
    spell it ``polyfit(x, y, degree, solver="qr_vandermonde")``."""
    warnings.warn(
        "polyfit_qr is deprecated; pass solver='qr_vandermonde' to polyfit "
        "(or FitSpec(numerics=NumericsPolicy(solver='qr_vandermonde')))",
        DeprecationWarning, stacklevel=2)
    return polyfit(x, y, int(degree), solver="qr_vandermonde",
                   fallback=None, device=device)


@dataclasses.dataclass(frozen=True)
class FitReport:
    """Everything the paper's Tables II-V report about one fit."""

    coeffs: torch.Tensor          # monomial, raw-x coefficients
    fitted: torch.Tensor          # f(x_i)
    residuals: torch.Tensor       # y_i - f(x_i)
    sse: torch.Tensor             # Σ e²
    r: torch.Tensor               # correlation coefficient R


def fit_report(poly: Polynomial, x: torch.Tensor,
               y: torch.Tensor) -> FitReport:
    fitted = poly(x)
    resid = y - fitted
    sse = torch.sum(resid * resid, dim=-1)
    ym = y - torch.mean(y, dim=-1, keepdim=True)
    fm = fitted - torch.mean(fitted, dim=-1, keepdim=True)
    r = torch.sum(ym * fm, dim=-1) / torch.sqrt(
        torch.sum(ym * ym, dim=-1) * torch.sum(fm * fm, dim=-1))
    coeffs = poly.coeffs
    if poly.basis == basis_lib.MONOMIAL and poly.coeffs.ndim == 1:
        coeffs = poly.monomial_coeffs()
    return FitReport(coeffs=coeffs, fitted=fitted, residuals=resid,
                     sse=sse, r=r)


@dataclasses.dataclass(frozen=True)
class StreamedFitReport:
    """``fit_report`` accuracy numbers computed in one streamed pass (no
    (..., n) fitted/residual arrays)."""

    coeffs: torch.Tensor          # the fit's coefficients
    sse: torch.Tensor             # Σ w e²
    r: torch.Tensor               # correlation coefficient R
    count: torch.Tensor           # Σ w (weighted mass used for the means)


def fit_report_streamed(poly: Polynomial, x, y, *, weights=None,
                        engine: str = "auto",
                        device=None) -> StreamedFitReport:
    """Fused-kernel ``fit_report``: SSE and R without materializing the
    (..., n) fitted/residual arrays.  Monomial fits take the fused report
    kernel on CUDA (its plain version on the CPU); Chebyshev fits and
    ``engine="reference"`` take the materializing pass."""
    from repro_torch import engine as engine_lib
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    plan = engine_lib.plan_fit(
        tuple(x.shape), poly.degree, basis=poly.basis, dtype=x.dtype,
        weighted=weights is not None, engine=engine, device=dev,
        workload="report")
    dom = basis_lib.Domain(poly.domain_shift.to(dev), poly.domain_scale.to(dev))
    s = engine_lib.compute_report_sums(plan, dom.apply(x), y,
                                       poly.coeffs.to(dev), weights=weights)
    n = s["sw"]
    cov = s["syf"] - s["sy"] * s["sf"] / n
    var_y = s["syy"] - s["sy"] * s["sy"] / n
    var_f = s["sff"] - s["sf"] * s["sf"] / n
    r = cov / torch.sqrt(var_y * var_f)
    return StreamedFitReport(coeffs=poly.coeffs, sse=s["sse"], r=r, count=n)


def _broadcast_moments(m: moments_lib.Moments, coeffs: torch.Tensor):
    """Expand moment leaves so ``coeffs`` may carry extra trailing batch
    axes beyond the moments' batch shape (a degree ladder)."""
    extra = coeffs.ndim - m.vty.ndim
    gram, vty, yty, sw = m.gram, m.vty, m.yty, m.weight_sum
    for _ in range(max(extra, 0)):
        gram = gram[..., None, :, :]
        vty = vty[..., None, :]
        yty = yty[..., None]
        sw = sw[..., None]
    return gram, vty, yty, sw


def _quad(coeffs, gram):
    return (coeffs[..., :, None] * gram * coeffs[..., None, :]).sum((-2, -1))


def sse_from_moments(m: moments_lib.Moments,
                     coeffs: torch.Tensor) -> torch.Tensor:
    """Σe² without touching the data: yᵀy - 2aᵀB + aᵀA a."""
    gram, vty, yty, _ = _broadcast_moments(m, coeffs)
    cross = (coeffs * vty).sum(-1)
    return yty - 2.0 * cross + _quad(coeffs, gram)


@spans.span("fit.report")
def report_from_moments(m: moments_lib.Moments,
                        coeffs: torch.Tensor) -> StreamedFitReport:
    """The full streamed report (SSE + R) from the O(m²) state alone."""
    gram, vty, syy, sw = _broadcast_moments(m, coeffs)
    sf = (coeffs * gram[..., 0, :]).sum(-1)
    sff = _quad(coeffs, gram)
    syf = (coeffs * vty).sum(-1)
    sy = vty[..., 0]
    sse = syy - 2.0 * syf + sff
    cov = syf - sy * sf / sw
    var_y = syy - sy * sy / sw
    var_f = sff - sf * sf / sw
    r = cov / torch.sqrt(var_y * var_f)
    return StreamedFitReport(coeffs=coeffs, sse=sse, r=r, count=sw)
