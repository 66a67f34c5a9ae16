"""Linear solvers for the (m+1)x(m+1) normal-equation system (port of
``repro.core.solve``).

``gaussian_elimination`` is the paper's method (Gauss-Jordan with partial
pivoting); ``qr_solve_vandermonde`` its MATLAB-polyfit baseline.  The
condition-aware ladder (Skala, arXiv:1802.07591) adds ``cholesky_solve``,
``qr_solve_gram``, the equilibrated ``svd_solve``, ``condition_estimate``,
the static ``select_solver`` and the runtime guard ``solve_with_fallback``.

Every function is batched over leading axes as plain tensor ops: no
Python loop over series.  On the card, ``solve_with_fallback`` hands the
``gauss`` rung for k <= 8 to one hand-written kernel
(``kernels/solve.py``), which reads nothing back to the host; the chain
below is its plain version and runs every other call.  Grams that
hold a non-finite entry are swapped for the identity before they reach a
LAPACK/cuSOLVER factorization, and their results are written as NaN (the
condition estimate as +inf), which is what the JAX reference returns for
them.
"""
from __future__ import annotations

import torch

# the explicit-solve ladder, in escalation order
SOLVERS = ("gauss", "cholesky", "qr", "svd")

# runtime condition caps (see the reference module for their derivation):
# past these the planned solver has lost every digit and the SVD rescue
# replaces its result
COND_CAP = {torch.float32: 3e7, torch.float64: 1e11}


def cond_cap_for(dtype) -> float:
    """Condition cap above which ``solve_with_fallback`` engages the SVD."""
    return COND_CAP.get(dtype, 3e7)


def _finite_or_eye(a: torch.Tensor):
    """(a with non-finite matrices replaced by I, mask of those matrices)."""
    bad = ~torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(bad[..., None, None], eye, a), bad


def _nan_where(bad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(bad[..., None], torch.full_like(x, float("nan")), x)


def gaussian_elimination(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a @ x = b by Gauss-Jordan elimination with partial pivoting.

    a: (..., m, m), b: (..., m).  The Python loop runs over the m columns
    only; every step is a batched row operation over all series."""
    m = a.shape[-1]
    aug = torch.cat([a, b[..., None]], dim=-1)            # (..., m, m+1)
    rows = torch.arange(m, device=a.device)
    neg_inf = torch.tensor(float("-inf"), dtype=a.dtype, device=a.device)
    for k in range(m):
        col = torch.where(rows < k, neg_inf, aug[..., :, k].abs())
        p = torch.argmax(col, dim=-1)                     # (...,)
        # swap rows k and p (row k <- p first, then row p <- k, as the
        # reference's two scatters do)
        perm = rows.expand(aug.shape[:-1]).clone()
        perm.scatter_(-1, p[..., None], k)
        perm[..., k] = p
        aug = torch.gather(aug, -2, perm[..., None].expand(aug.shape))
        pivot = aug[..., k, k]
        factors = aug[..., :, k] / pivot[..., None]
        factors[..., k] = 0.0
        aug = aug - factors[..., :, None] * aug[..., k, None, :]
    return aug[..., :, m] / torch.diagonal(aug[..., :, :m], dim1=-2, dim2=-1)


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve via Cholesky.  ``cholesky_ex`` does not raise or sync on a
    non-PD Gram; its result is written as NaN there, as the reference's
    ``jnp.linalg.cholesky`` returns."""
    a_safe, bad = _finite_or_eye(a)
    chol, info = torch.linalg.cholesky_ex(a_safe)
    bad = bad | (info != 0)
    chol = torch.where(bad[..., None, None],
                       torch.full_like(chol, float("nan")), chol)
    y = torch.linalg.solve_triangular(chol, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def qr_solve_vandermonde(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """polyfit()-style solve: V = QR, coeffs = R⁻¹ Qᵀ y.  Acts on the full
    n×(m+1) design matrix, so it is NOT matricizable — the paper's point."""
    q, r = torch.linalg.qr(v)
    qty = torch.einsum("...nk,...n->...k", q, y)
    return torch.linalg.solve_triangular(r, qty[..., None], upper=True)[..., 0]


def qr_solve_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Householder-QR solve of the (m+1)×(m+1) Gram system."""
    a_safe, bad = _finite_or_eye(a)
    q, r = torch.linalg.qr(a_safe)
    qtb = torch.einsum("...ji,...j->...i", q, b)
    x = torch.linalg.solve_triangular(r, qtb[..., None], upper=True)[..., 0]
    return _nan_where(bad, x)


def svd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rank-revealing minimum-norm solve: Jacobi-equilibrate (A' = DAD,
    D = diag(A)^-½), SVD, truncate below eps·(m+1)·σmax, invert."""
    a_safe, bad = _finite_or_eye(a)
    d = torch.diagonal(a_safe, dim1=-2, dim2=-1)
    one = torch.ones_like(d)
    d = torch.where(d > 0, torch.rsqrt(torch.where(d > 0, d, one)), one)
    ae = a_safe * d[..., :, None] * d[..., None, :]
    be = b * d
    u, s, vt = torch.linalg.svd(ae)
    cutoff = (torch.finfo(a.dtype).eps * a.shape[-1]
              * torch.amax(s, dim=-1, keepdim=True))
    keep = s > cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = torch.einsum("...ji,...j->...i", u, be)
    xe = torch.einsum("...ji,...j->...i", vt, s_inv * utb)
    return _nan_where(bad, xe * d)


def condition_estimate(a: torch.Tensor) -> torch.Tensor:
    """2-norm condition number κ(A) of the symmetric Gram, batched, from
    ``eigvalsh`` of the Gram scaled by its largest |entry| (κ is scale-
    invariant).  +inf for singular, all-zero or non-finite matrices."""
    a_safe, bad = _finite_or_eye(a)
    amax = torch.amax(a_safe.abs(), dim=(-2, -1), keepdim=True)
    an = a_safe / torch.where(amax > 0, amax, torch.ones_like(amax))
    w = torch.linalg.eigvalsh(an).abs()
    wmax = torch.amax(w, dim=-1)
    wmin = torch.amin(w, dim=-1)
    inf = torch.full_like(wmax, float("inf"))
    cond = torch.where(wmin > 0,
                       wmax / torch.where(wmin > 0, wmin,
                                          torch.ones_like(wmin)), inf)
    return torch.where(bad, inf, cond)


def select_solver(degree: int, dtype, *, basis: str = "monomial",
                  normalized: bool = False) -> str:
    """Static GE → Cholesky → QR → SVD choice from degree/dtype/basis."""
    f64 = torch.finfo(dtype).eps < 1e-9
    if normalized or basis == "chebyshev":
        if degree <= 5:
            return "gauss"
        if degree <= 8:
            return "cholesky"
        return "qr" if f64 else "svd"
    if degree <= 3:
        return "gauss"
    if degree <= 5:
        return "cholesky" if f64 else "qr"
    return "qr" if f64 else "svd"


def solve(a: torch.Tensor, b: torch.Tensor,
          method: str = "gauss") -> torch.Tensor:
    if method == "gauss":
        return gaussian_elimination(a, b)
    if method == "cholesky":
        return cholesky_solve(a, b)
    if method == "qr":
        return qr_solve_gram(a, b)
    if method == "svd":
        return svd_solve(a, b)
    raise ValueError(f"unknown solve method {method!r}; "
                     f"expected one of {SOLVERS}")


def solve_with_fallback(a: torch.Tensor, b: torch.Tensor, *,
                        method: str = "gauss",
                        fallback: str | None = "svd",
                        cond_cap: float | None = None):
    """Condition-guarded solve.  Returns ``(x, cond, fallback_used)``.

    The fallback engages where κ(A) exceeds ``cond_cap`` (default
    per-dtype ``COND_CAP``) or the primary output is non-finite; no host
    branch on a device value.  ``fallback=None`` turns the guard off
    (fallback_used is all False).  A CUDA call that ``kernels.solve.takes``
    accepts runs as one kernel launch; every other call runs
    ``solve_with_fallback_plain``."""
    cap = float(cond_cap) if cond_cap is not None else cond_cap_for(a.dtype)
    from repro_torch.kernels import solve as ksolve
    if ksolve.takes(a, b, method, fallback):
        return ksolve.solve_small(a, b, method=method, fallback=fallback,
                                  cond_cap=cap)
    return solve_with_fallback_plain(a, b, method=method, fallback=fallback,
                                     cond_cap=cap)


def solve_with_fallback_plain(a: torch.Tensor, b: torch.Tensor, *,
                              method: str = "gauss",
                              fallback: str | None = "svd",
                              cond_cap: float | None = None):
    """``solve_with_fallback`` as tensor ops, the solve kernel's plain
    version: both branches computed for every series and selected with
    ``torch.where``."""
    cap = float(cond_cap) if cond_cap is not None else cond_cap_for(a.dtype)
    cond = condition_estimate(a)
    x = solve(a, b, method)
    if fallback is None:
        return x, cond, torch.zeros(cond.shape, dtype=torch.bool,
                                    device=a.device)
    bad = ~torch.isfinite(x).all(dim=-1) | ~(cond <= cap)
    if fallback == method:
        return x, cond, bad
    x = torch.where(bad[..., None], solve(a, b, fallback), x)
    return x, cond, bad
