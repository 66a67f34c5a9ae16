"""The plain reference: least squares from float64 power sums, in plain
PyTorch.  It imports nothing of the program (``repro_torch``), nothing of
the JAX package and not ``jax``, and works everything out again from the
inputs the benchmark made: the power sums, the domain, the solve.

For a degree-d fit in the variable t = (x - shift)·scale the moments are
the Hankel Gram G[j, k] = Σ t^(j+k), the right side v[k] = Σ t^k y, Σ y²
and the count.  The least-squares coefficients c solve (G + ridge·I) c = v,
and SSE(c) = Σ y² - 2 c·v + cᵀ G c.

The number that decides ``correct`` for a fit is its relative excess
SSE: (c - c_ref)ᵀ G (c - c_ref) / SSE(c_ref), the share by which the
program's polynomial fits its own data worse than the reference's (exact
for the unregularized minimizer, and within ridge·|c|² of it here).

``CONTROL`` is the same reference computed one precision below the
configurations' float32: the inputs and the stored power sums in
bfloat16 (as a bfloat16 matrix product hands them back: float32
accumulation, a bfloat16 result), the solve in float32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = torch.float64
BLOCK_POINTS = 1 << 24        # points per block of the float64 sums


@dataclasses.dataclass
class Sums:
    """Power sums of one or many series: s[..., k] = Σ t^k (k ≤ 2d),
    r[..., k] = Σ t^k y (k ≤ d), yy = Σ y²."""

    s: torch.Tensor
    r: torch.Tensor
    yy: torch.Tensor

    @property
    def degree(self) -> int:
        return self.r.shape[-1] - 1

    @property
    def count(self) -> torch.Tensor:
        return self.s[..., 0]

    def gram(self) -> torch.Tensor:
        d = self.degree
        idx = torch.arange(d + 1, device=self.s.device)
        return self.s[..., idx[:, None] + idx[None, :]]

    def to(self, dtype) -> "Sums":
        return Sums(self.s.to(dtype), self.r.to(dtype), self.yy.to(dtype))

    def rounded(self, dtype) -> "Sums":
        """The sums stored in ``dtype`` and read back."""
        return Sums(*(a.to(dtype).to(self.s.dtype)
                      for a in (self.s, self.r, self.yy)))


def _powers(t, y, degree: int, reduce):
    """Σ t^k (k ≤ 2d), Σ t^k y (k ≤ d), Σ y² by iterated products, each
    reduced by ``reduce``."""
    s, r = [], []
    p = torch.ones_like(t)
    for k in range(2 * degree + 1):
        s.append(reduce(p))
        if k <= degree:
            r.append(reduce(p * y))
        p = p * t
    return (torch.stack(s, -1), torch.stack(r, -1), reduce(y * y))


def _prep(x, y, control: bool):
    if control:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    return x.to(F64), y.to(F64)


def series_sums(x, y, offsets: np.ndarray, degree: int, *,
                control: bool = False, block: int = BLOCK_POINTS) -> Sums:
    """Power sums of each series of a flat pool (series i is
    ``[offsets[i], offsets[i+1])``), in blocks of points."""
    n_series = len(offsets) - 1
    dev = x.device
    s = torch.zeros(n_series, 2 * degree + 1, dtype=F64, device=dev)
    r = torch.zeros(n_series, degree + 1, dtype=F64, device=dev)
    yy = torch.zeros(n_series, dtype=F64, device=dev)
    bounds = torch.as_tensor(offsets[1:], device=dev)
    total = int(offsets[-1])
    for lo in range(0, total, block):
        hi = min(lo + block, total)
        ids = torch.searchsorted(bounds, torch.arange(lo, hi, device=dev),
                                 right=True)
        t, yv = _prep(x[lo:hi], y[lo:hi], control)

        def seg(v):
            out = torch.zeros(n_series, dtype=F64, device=dev)
            return out.index_add_(0, ids, v)
        bs, br, byy = _powers(t, yv, degree, seg)
        s += bs
        r += br
        yy += byy
    return Sums(s, r, yy)


def row_sums(x, y, degree: int, *, control: bool = False,
             block: int = BLOCK_POINTS) -> Sums:
    """Power sums of each row of (B, n) x and y, in blocks of rows."""
    b, n = x.shape
    rows = max(1, block // max(n, 1))
    parts = []
    for lo in range(0, b, rows):
        t, yv = _prep(x[lo:lo + rows], y[lo:lo + rows], control)
        parts.append(_powers(t, yv, degree, lambda v: v.sum(-1)))
    return Sums(*(torch.cat([p[i] for p in parts]) for i in range(3)))


def solve(m: Sums, ridge: float) -> torch.Tensor:
    """c with (G + ridge·I) c = v, in the sums' dtype (float32 for the
    control, whose sums come in bfloat16)."""
    g = m.gram()
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return torch.linalg.solve(g + ridge * eye, m.r)


def sse(m: Sums, c: torch.Tensor) -> torch.Tensor:
    m = m.to(F64)
    c = c.to(F64)
    quad = torch.einsum("...j,...jk,...k->...", c, m.gram(), c)
    return m.yy - 2.0 * (c * m.r).sum(-1) + quad


def excess(m: Sums, c_ref: torch.Tensor, sse_ref: torch.Tensor,
           c: torch.Tensor) -> torch.Tensor:
    """(c - c_ref)ᵀ G (c - c_ref) / SSE(c_ref) per series, float64."""
    d = c.to(F64) - c_ref.to(F64)
    quad = torch.einsum("...j,...jk,...k->...", d, m.to(F64).gram(), d)
    return quad / sse_ref


def rebase(c: np.ndarray, shift_from: float, scale_from: float,
           shift_to: float, scale_to: float) -> np.ndarray:
    """Coefficients of p(t_from) re-expressed in t_to, both of the form
    (x - shift)·scale: t_from = α t_to + β, expanded in float64."""
    alpha = scale_from / scale_to
    beta = scale_from * (shift_to - shift_from)
    c = np.asarray(c, np.float64)
    out = np.zeros_like(c)
    term = np.zeros_like(c)
    term[..., 0] = 1.0                       # (α t + β)^0
    for k in range(c.shape[-1]):
        out = out + c[..., k:k + 1] * term
        nxt = np.zeros_like(term)
        nxt[..., 1:] += alpha * term[..., :-1]
        nxt += beta * term
        term = nxt
    return out
