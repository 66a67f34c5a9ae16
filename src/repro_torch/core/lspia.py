"""LSPIA: least-squares progressive-iterative approximation, matrix-free
(port of ``repro.core.lspia``).

Iterate ``c ← c + μ · Vᵀ W (y − V c)`` with both operators applied
matrix-free: ``V c`` is Horner/Clenshaw evaluation and ``Vᵀ r`` an
iterated-multiply reduction, so the working state is O(m) coefficients plus
one O(n) residual stream, never the O(m²) Gram.  The fixed point is the
weighted LSE solution (Richardson iteration on the normal equations; it
converges for 0 < μ < 2/λmax(VᵀWV)).  μ comes from a matrix-free
power-iteration estimate of λmax.

The iteration is a Python loop over torch ops: each sweep reads one flag
(``any`` lane still live) back to the host to decide whether to stop, the
same condition as the reference's ``while_loop``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib


@dataclasses.dataclass(frozen=True)
class LSPIAFit:
    """An LSPIA fit: polynomial + the iteration's convergence record."""

    poly: fit_lib.Polynomial
    iterations: int               # iterations actually run
    converged: torch.Tensor       # (...,) ‖∇‖ fell below tol·‖Vᵀwy‖
    grad_norm: torch.Tensor       # (...,) final ‖Vᵀ W (y - Vc)‖₂
    step: torch.Tensor            # (...,) μ used (1/λ̂max)


def vt_apply(x: torch.Tensor, r: torch.Tensor, degree: int, *,
             basis: str = basis_lib.MONOMIAL) -> torch.Tensor:
    """Matrix-free Vᵀ r over the last axis: out[k] = Σ_i basis_k(x_i)·r_i.

    Iterated multiply for monomials, the three-term recurrence for
    Chebyshev: O(n·m) work, no (n, m+1) Vandermonde materialized."""
    if basis not in (basis_lib.MONOMIAL, basis_lib.CHEBYSHEV):
        raise ValueError(f"unknown basis {basis!r}")
    outs = [torch.sum(r, dim=-1)]
    if degree >= 1:
        prev, cur = r, x * r
        outs.append(torch.sum(cur, dim=-1))
        for _ in range(2, degree + 1):
            if basis == basis_lib.MONOMIAL:
                prev, cur = cur, x * cur
            else:
                prev, cur = cur, 2.0 * x * cur - prev
            outs.append(torch.sum(cur, dim=-1))
    return torch.stack(outs, dim=-1)


def _normal_op(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
               degree: int, basis: str) -> torch.Tensor:
    """Matrix-free (VᵀWV)·c — evaluate then reduce, never the Gram."""
    f = basis_lib.evaluate(c, x, basis=basis)
    return vt_apply(x, w * f, degree, basis=basis)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=-1)


def _power_iter(op, shape, dtype, device, iters: int,
                with_prev: bool = False):
    """Largest eigenvalue of the SPD operator ``op`` by power iteration.

    ``with_prev=True`` also returns the previous sweep's estimate: a large
    relative gap between the last two means the estimate is still
    climbing and must not be trusted as λmax."""
    m1 = shape[-1]
    v = torch.broadcast_to(
        torch.ones(m1, dtype=dtype, device=device)
        / torch.sqrt(torch.tensor(m1, dtype=dtype, device=device)), shape)
    lam = torch.ones(shape[:-1], dtype=dtype, device=device)
    prev = torch.ones(shape[:-1], dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    for _ in range(iters):
        av = op(v)
        lam, prev = _norm(av), lam
        v = av / torch.clamp(lam[..., None], min=tiny)
    return (lam, prev) if with_prev else lam


def _lambda_max(x: torch.Tensor, w: torch.Tensor, degree: int, basis: str,
                iters: int, with_prev: bool = False):
    """Power-iteration λmax(VᵀWV) from V/Vᵀ passes only (batched)."""
    return _power_iter(lambda v: _normal_op(x, w, v, degree, basis),
                       tuple(x.shape[:-1]) + (degree + 1,), x.dtype,
                       x.device, iters, with_prev)


def _trace_normal(x: torch.Tensor, w: torch.Tensor, degree: int,
                  basis: str) -> torch.Tensor:
    """Matrix-free trace(VᵀWV) = Σᵢ wᵢ Σₖ basisₖ(xᵢ)²: one O(n·m) pass.
    trace(A) ≥ λmax(A) for SPD A, so 1/trace is an always-convergent
    (if slow) Richardson step."""
    tr = torch.sum(w, dim=-1)
    if degree >= 1:
        prev, cur = torch.ones_like(x), x
        tr = tr + torch.sum(w * cur * cur, dim=-1)
        for _ in range(2, degree + 1):
            if basis == basis_lib.MONOMIAL:
                prev, cur = cur, x * cur
            else:
                prev, cur = cur, 2.0 * x * cur - prev
            tr = tr + torch.sum(w * cur * cur, dim=-1)
    return tr


def _gram_lambda_ub(gram: torch.Tensor) -> torch.Tensor:
    """Guaranteed upper bound on λmax of the (batched) SPD Gram:
    min(trace, Gershgorin max-row-sum).  Clamping the power estimate from
    below by half of it keeps μ·λmax < 2 even when the power iteration
    under-estimated λmax on a clustered spectrum."""
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    gersh = torch.amax(torch.sum(torch.abs(gram), dim=-1), dim=-1)
    return torch.minimum(tr, gersh)


# relative gradient-norm growth beyond this is divergence, not a heavy-ball
# transient: the lane freezes at its last finite iterate and reports
# converged=False (finite coefficients are guaranteed)
_DIVERGE_FACTOR = 1e6


def _condition_from_rate(rho: torch.Tensor,
                         lam_mu: torch.Tensor) -> torch.Tensor:
    """Matrix-free κ̂(VᵀWV) from the iteration's own contraction rate
    ρ = 1 − μ·λmin: κ = λmax·μ/(1 − ρ), a lower bound when the run stopped
    before its asymptotic regime; ρ ≥ 1 reports +inf."""
    inf = torch.full_like(rho, float("inf"))
    denom = 1.0 - rho
    pos = denom > 0
    return torch.where(
        pos, torch.clamp(lam_mu / torch.where(pos, denom,
                                              torch.ones_like(denom)),
                         min=1.0), inf)


def _tol_floor(tol: float, dtype) -> float:
    # the gradient is recomputed from O(n) sums each sweep, so its relative
    # floor is ~eps·√n of gref: clamp tol there or f32 fits spin to
    # max_iter chasing an unreachable residual
    return max(float(tol), 25.0 * float(torch.finfo(dtype).eps))


def _iterate(grad, c0, g_init, gref, mu, beta, tol: float, cap,
             max_iter: int):
    """The Richardson / heavy-ball loop shared by both entry points.

    Runs while ``it < max_iter`` and some lane is live (gradient above
    tol·gref, finite and under the divergence cap); a lane whose gradient
    blew past the cap keeps its last finite iterate.  Returns
    ``(c, gnorm, gprev, iterations)``."""
    c, cp = c0, c0
    gnorm = g_init
    gprev = torch.full_like(g_init, float("inf"))
    it = 0
    while it < max_iter:
        live = (gnorm > tol * gref) & (gnorm <= cap) & torch.isfinite(gnorm)
        if not bool(torch.any(live)):
            break
        g = grad(c)
        gn = _norm(g)
        ok = (torch.isfinite(gn) & (gn <= cap))[..., None]
        upd = c + mu[..., None] * g + beta * (c - cp)
        c, cp = torch.where(ok, upd, c), torch.where(ok, c, cp)
        gnorm, gprev = gn, gnorm
        it += 1
    return c, gnorm, gprev, it


def _finish(c, gnorm, gprev, gref, tol, lam_safe, mu):
    """Converged flags, scrubbed coefficients and the rate-based κ̂."""
    converged = gnorm <= tol * gref
    # the freeze guard keeps iterates finite unless the INPUT was already
    # non-finite; scrub that too
    finite = torch.all(torch.isfinite(c), dim=-1)
    c = torch.where(finite[..., None], c, torch.zeros_like(c))
    converged = converged & finite
    ok = torch.isfinite(gprev) & (gprev > 0)
    rho = torch.where(ok, gnorm / torch.where(gprev > 0, gprev,
                                              torch.ones_like(gprev)),
                      torch.zeros_like(gnorm))
    return c, converged, _condition_from_rate(rho, lam_safe * mu)


def lspia_solve_moments(gram: torch.Tensor, vty: torch.Tensor, *,
                        tol: float = 1e-8,
                        max_iter: int = 5000,
                        power_iters: int = 12,
                        step: float | None = None,
                        momentum: float = 0.0):
    """LSPIA's fixed point from the O(m²) moment state alone:
    ``c ← c + μ (B − A c)`` on A = VᵀWV, B = VᵀWy (streams and slot pools
    hold the moments, not the data).

    Batched over leading axes.  Returns ``(coeffs, condition, converged,
    iterations)``.  An all-zero state (idle serve slot) converges at once
    to c = 0.  ``momentum`` > 0 adds the heavy-ball term β·(cₖ − cₖ₋₁).
    μ = 1/λ̂max is clamped from below by half the Gershgorin/trace bound
    on λmax, and a lane that still fails to contract freezes at its last
    finite iterate and reports ``converged=False``."""
    dtype = gram.dtype

    def mv(c):
        return torch.einsum("...jk,...k->...j", gram, c)

    tiny = torch.finfo(dtype).tiny
    lam = _power_iter(mv, tuple(vty.shape), dtype, gram.device, power_iters)
    lam_safe = torch.maximum(lam, 0.5 * _gram_lambda_ub(gram))
    if step is None:
        mu = 1.0 / torch.clamp(lam_safe, min=tiny)
    else:
        mu = torch.full(vty.shape[:-1], step, dtype=dtype,
                        device=gram.device)
    beta = torch.tensor(momentum, dtype=dtype, device=gram.device)
    gref = torch.clamp(_norm(vty), min=tiny)
    tol = _tol_floor(tol, dtype)
    cap = _DIVERGE_FACTOR * gref
    c0 = torch.zeros_like(vty)
    g0 = _norm(vty - mv(c0))
    c, gnorm, gprev, it = _iterate(lambda c: vty - mv(c), c0, g0, gref, mu,
                                   beta, tol, cap, max_iter)
    c, converged, cond = _finish(c, gnorm, gprev, gref, tol, lam_safe, mu)
    return c, cond, converged, it


def lspia_solve_spec(m, spec):
    """The moment-space LSPIA answer of a ``FitSpec`` (method="lspia") on
    ``Moments`` ``m``: the spec's ridge, then ``lspia_solve_moments`` under
    its ``LSPIAOptions``.  The one readout ``api.stream_result`` and the
    fit server's per-request solve share.  Returns ``(coeffs, condition,
    converged, iterations)``."""
    if spec.ridge:
        m = m.regularized(spec.ridge)
    opts = spec.lspia
    return lspia_solve_moments(m.gram, m.vty, tol=opts.tol,
                               max_iter=opts.max_iter,
                               power_iters=opts.power_iters, step=opts.step,
                               momentum=opts.momentum)


def lspia_fit_spec(x: torch.Tensor, y: torch.Tensor,
                   weights: torch.Tensor | None, init: torch.Tensor | None,
                   spec) -> LSPIAFit:
    """The matrix-free LSPIA engine, keyed on a ``FitSpec``
    (method="lspia"); ``api.fit`` calls it directly.

    Stops when ‖Vᵀ W (y − Vc)‖ ≤ tol·‖Vᵀ W y‖ or at ``max_iter``.
    ``step=None`` estimates μ = 1/λmax by matrix-free power iteration and
    trusts it only when its last two sweeps agree within 5%; otherwise it
    falls back to μ = 1/trace.  Batched over leading axes; the loop runs
    until every series converges."""
    degree = int(spec.degree)
    basis = spec.basis
    opts = spec.lspia
    plan = spec.plan(tuple(x.shape), x.dtype, weighted=weights is not None,
                     workload="lspia", device=x.device)
    dom = basis_lib.Domain.choose(
        x, normalize=plan.numerics.normalize,
        pinned=spec.domain_or(dtype=x.dtype, device=x.device))
    xt = dom.apply(x)
    w = torch.ones_like(x) if weights is None else weights
    if spec.decay < 1.0:
        from repro_torch.core import moments as moments_lib
        w = w * moments_lib.decay_ladder(x.shape[-1], spec.decay, x.dtype,
                                         x.device)
    # spec.ridge shifts the fixed point to the Tikhonov solution, as the
    # moment-space surfaces regularize the Gram: an extra −λc term
    ridge = torch.tensor(spec.ridge, dtype=x.dtype, device=x.device)
    tiny = torch.finfo(x.dtype).tiny

    lam, lam_prev = _lambda_max(xt, w, degree, basis, opts.power_iters,
                                with_prev=True)
    lam = lam + ridge
    # the power estimate is trusted only when its last two sweeps agree
    # (settled); otherwise μ = 1/trace, unconditionally convergent
    tr_ub = (_trace_normal(xt, w, degree, basis)
             + ridge * torch.tensor(degree + 1, dtype=x.dtype,
                                    device=x.device))
    settled = torch.abs(lam - (lam_prev + ridge)) <= 0.05 * lam
    lam_safe = torch.where(settled, lam, torch.maximum(lam, tr_ub))
    if opts.step is None:
        mu = 1.0 / torch.clamp(lam_safe, min=tiny)
    else:
        mu = torch.full(tuple(x.shape[:-1]), opts.step, dtype=x.dtype,
                        device=x.device)
    beta = torch.tensor(opts.momentum, dtype=x.dtype, device=x.device)

    gref = torch.clamp(_norm(vt_apply(xt, w * y, degree, basis=basis)),
                       min=tiny)
    tol = _tol_floor(opts.tol, x.dtype)
    cap = _DIVERGE_FACTOR * gref
    c0 = (torch.zeros(tuple(x.shape[:-1]) + (degree + 1,), dtype=x.dtype,
                      device=x.device) if init is None else init)

    def grad(c):
        f = basis_lib.evaluate(c, xt, basis=basis)
        return vt_apply(xt, w * (y - f), degree, basis=basis) - ridge * c

    # the first sweep starts from a finite "not yet measured" gradient
    # norm above tol·gref, so every lane is live
    c, gnorm, gprev, it = _iterate(grad, c0, cap, gref, mu, beta, tol, cap,
                                   opts.max_iter)
    c, converged, cond = _finish(c, gnorm, gprev, gref, tol, lam_safe, mu)
    # condition is the matrix-free κ̂; fallback_used doubles as "did NOT
    # meet tol within max_iter" (LSPIA has no rescue solver)
    diag = fit_lib.FitDiagnostics(condition=cond, fallback_used=~converged,
                                  solver="lspia", fallback="none")
    poly = fit_lib.Polynomial(coeffs=c, domain_shift=dom.shift,
                              domain_scale=dom.scale, basis=basis,
                              diagnostics=diag)
    return LSPIAFit(poly=poly, iterations=it, converged=converged,
                    grad_norm=gnorm, step=mu)


def lspia_fit(x, y, degree: int, *, weights=None,
              basis: str = basis_lib.MONOMIAL,
              normalize: bool = True,
              tol: float = 1e-8,
              max_iter: int = 5000,
              power_iters: int = 12,
              step: float | None = None,
              momentum: float = 0.0,
              init=None,
              engine: str = "auto",
              device=None) -> LSPIAFit:
    """Gram-free iterative LSE fit: a shim that builds ``FitSpec(method=
    "lspia", lspia=LSPIAOptions(...))`` and runs ``lspia_fit_spec``.
    ``normalize=True`` (LSPIA needs a bounded domain for its first-order
    rate) maps the sample range to [-1, 1].  ``device=None`` means CUDA."""
    from repro_torch.api import spec as spec_lib
    from repro_torch.device import as_tensor, resolve_device
    from repro_torch.engine import plan as plan_lib
    spec = spec_lib.FitSpec(
        degree=int(degree), basis=basis, method="lspia",
        lspia=spec_lib.LSPIAOptions(tol=float(tol), max_iter=int(max_iter),
                                    power_iters=int(power_iters),
                                    step=None if step is None
                                    else float(step),
                                    momentum=float(momentum)),
        numerics=plan_lib.NumericsPolicy(normalize=normalize,
                                         solver="auto"),
        engine=engine)
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    weights = None if weights is None else as_tensor(weights, dev)
    init = None if init is None else as_tensor(init, dev)
    return lspia_fit_spec(x, y, weights, init, spec)
