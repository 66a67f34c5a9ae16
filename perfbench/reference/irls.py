"""The plain IRLS reference: Huber and Tukey M-estimates of polynomial
fits by iteratively reweighted least squares, in plain PyTorch and
float64.  It imports nothing of the program (``repro_torch``), nothing of
the JAX package and not ``jax``, and works everything out again from the
inputs the benchmark made.

The definitions (Huber 1981; Beaton and Tukey 1974), for a degree-d fit
of each row of (B, n) x and y in the raw variable t = x:

* the start is least squares at unit weights;
* a sweep takes the residuals r = y - p(t) and the scale
  σ̂ = 1.4826·median(|r|), the median of an even count the mean of the
  two middle values; then u = r / σ̂ and the weights ψ(u)/u: Tukey
  w = (1 - (u/c)²)² for |u| < c and 0 beyond, c = 4.685; Huber w = 1 for
  |u| ≤ c and c/|u| beyond, c = 1.345;
* the next coefficients solve the weighted normal equations
  Σ w t^(j+k) c_k = Σ w t^j y, the power sums computed in blocks of
  ``BLOCK_POINTS`` points (whole rows);
* it iterates to the fixed point: until every row's
  max|Δc| / max(max|c|, 1) ≤ ``REL_TOL``, or ``MAX_SWEEPS`` sweeps.

Departures from the upstream robust row (``benchmarks/run.py``, row
``irls``, which calls the JAX package's ``robust_polyfit``):

* the stopping rule is the fixed point above, not the row's (the
  program's) tol = max(1e-6, 500·eps) with at most 30 sweeps;
* every point is live: the reference takes no base weights;
* σ̂ is floored at eps·(1 + median|y|) (float64's eps), which keeps u
  finite on an exact fit and never binds on noisy data;
* the MAD is of |r| about zero, as the row's, for the fit centres the
  residuals; not of |r - median(r)|.

``CONTROL`` (``control=True``) is the same reference one precision below
the configurations' float32: the inputs in bfloat16, the residuals,
scales and weights in float32, the weighted power sums accumulated in
float32 and stored in bfloat16 (as a bfloat16 matrix product hands them
back), the solves in float32.

The number that decides ``correct`` for a robust fit is its relative
excess weighted SSE at the reference's final weights w:
(c - c_ref)ᵀ G_w (c - c_ref) / SSE_w(c_ref), with G_w the float64
weighted Gram and SSE_w(c_ref) = Σ w (y - p_ref)²: the share by which
the answer fits the reference's weighted problem worse than the
reference's own minimizer does.
"""
from __future__ import annotations

import dataclasses

import torch

F64 = torch.float64
BLOCK_POINTS = 1 << 24        # points per block (whole rows)
TUNING = {"huber": 1.345, "tukey": 4.685}
MAD_TO_SD = 1.4826            # σ̂ of a Gaussian from its MAD
REL_TOL = 1e-10
MAX_SWEEPS = 100


@dataclasses.dataclass
class Fit:
    """A robust fit of each row: ``coeffs`` (B, d+1) in the raw variable;
    at the final weights w(coeffs), ``gram`` (B, d+1, d+1) = Σ w t^(j+k)
    and ``sse`` (B,) = Σ w (y - p)², both float64 (None in the control);
    ``sweeps`` (B,) the sweeps a row took to its fixed point;
    ``converged`` (B,) whether it got there."""

    coeffs: torch.Tensor
    gram: torch.Tensor | None
    sse: torch.Tensor | None
    sweeps: torch.Tensor
    converged: torch.Tensor


def weights(u: torch.Tensor, loss: str, c: float) -> torch.Tensor:
    """ψ(u)/u of the standardized residuals u."""
    au = u.abs()
    if loss == "tukey":
        return torch.where(au < c, (1.0 - (u / c) ** 2) ** 2,
                           torch.zeros_like(u))
    if loss == "huber":
        return torch.where(au <= c, torch.ones_like(u),
                           c / torch.clamp(au, min=c))
    raise ValueError(f"unknown loss {loss!r}")


def median(a: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, keeping it: the mean of the two middle
    values of an even count."""
    s = torch.sort(a, dim=-1).values
    n = a.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2:(n - 1) // 2 + 1]
                  + s[..., n // 2:n // 2 + 1])


def horner(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """p(t) of each row: c (rows, d+1), t (rows, n)."""
    d = c.shape[-1] - 1
    acc = c[:, d:d + 1].expand_as(t)
    for k in range(d - 1, -1, -1):
        acc = acc * t + c[:, k:k + 1]
    return acc


def power_sums(t, y, w, degree: int):
    """s[..., k] = Σ w t^k (k ≤ 2d) and r[..., k] = Σ w t^k y (k ≤ d),
    by iterated products."""
    s, r = [], []
    p = w
    for k in range(2 * degree + 1):
        s.append(p.sum(-1))
        if k <= degree:
            r.append((p * y).sum(-1))
        p = p * t
    return torch.stack(s, -1), torch.stack(r, -1)


def hankel(s: torch.Tensor, degree: int) -> torch.Tensor:
    idx = torch.arange(degree + 1, device=s.device)
    return s[..., idx[:, None] + idx[None, :]]


def solve(t, y, w, degree: int, control: bool) -> torch.Tensor:
    """The weighted least-squares coefficients (the control's sums stored
    in bfloat16)."""
    s, r = power_sums(t, y, w, degree)
    if control:
        s = s.to(torch.bfloat16).to(t.dtype)
        r = r.to(torch.bfloat16).to(t.dtype)
    return torch.linalg.solve(hankel(s, degree), r)


def _block(x, y, degree: int, loss: str, c: float, control: bool):
    if control:
        t = x.to(torch.bfloat16).to(torch.float32)
        yv = y.to(torch.bfloat16).to(torch.float32)
    else:
        t, yv = x.to(F64), y.to(F64)
    floor = torch.finfo(t.dtype).eps * (1.0 + median(yv.abs()))

    def scale_of(coeffs):
        r = yv - horner(coeffs, t)
        return r, torch.maximum(MAD_TO_SD * median(r.abs()), floor)

    coeffs = solve(t, yv, torch.ones_like(t), degree, control)
    rows = t.shape[0]
    sweeps = torch.zeros(rows, dtype=torch.int64, device=t.device)
    done = torch.zeros(rows, dtype=torch.bool, device=t.device)
    for _ in range(MAX_SWEEPS):
        r, sigma = scale_of(coeffs)
        new = solve(t, yv, weights(r / sigma, loss, c), degree, control)
        size = torch.clamp(new.abs().amax(-1), min=1.0)
        delta = (new - coeffs).abs().amax(-1) / size
        coeffs = new
        sweeps += (~done).to(torch.int64)
        done |= delta <= REL_TOL
        if bool(done.all()):
            break
    gram = sse = None
    if not control:
        r, sigma = scale_of(coeffs)
        w = weights(r / sigma, loss, c)
        gram = hankel(power_sums(t, yv, w, degree)[0], degree)
        sse = (w * r * r).sum(-1)
    return coeffs, gram, sse, sweeps, done


def fit(x: torch.Tensor, y: torch.Tensor, degree: int, loss: str, *,
        c: float | None = None, control: bool = False,
        block: int = BLOCK_POINTS) -> Fit:
    """The robust fit of every row of (B, n) x and y, in blocks of whole
    rows of at most ``block`` points (one row where a row is longer)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = TUNING[loss] if c is None else float(c)
    b, n = x.shape
    rows = max(1, block // max(n, 1))
    parts = [_block(x[lo:lo + rows], y[lo:lo + rows], degree, loss, c,
                    control) for lo in range(0, b, rows)]

    def cat(i):
        return None if parts[0][i] is None else torch.cat(
            [p[i] for p in parts])
    return Fit(*(cat(i) for i in range(5)))


def excess(ref: Fit, c: torch.Tensor) -> torch.Tensor:
    """(c - c_ref)ᵀ G_w (c - c_ref) / SSE_w(c_ref) of each row, float64."""
    d = c.to(F64) - ref.coeffs.to(F64)
    quad = torch.einsum("...j,...jk,...k->...", d, ref.gram, d)
    return quad / ref.sse
