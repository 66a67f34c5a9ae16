"""Polynomial bases and domain normalization (port of ``repro.core.basis``).

The paper works in the raw monomial basis ``1, x, x^2, ...``.  The affine
domain map to [-1, 1] and the Chebyshev basis improve the conditioning of
the Gram matrix ``VᵀV`` while leaving the fitted function unchanged.
"""
from __future__ import annotations

import dataclasses
from math import comb

import numpy as np
import torch

MONOMIAL = "monomial"
CHEBYSHEV = "chebyshev"
_BASES = (MONOMIAL, CHEBYSHEV)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Affine map t = scale * (x - shift) applied before basis evaluation.

    ``identity()`` is the paper-faithful no-op domain."""

    shift: torch.Tensor  # scalar
    scale: torch.Tensor  # scalar

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Domain":
        return Domain(torch.zeros((), dtype=dtype, device=device),
                      torch.ones((), dtype=dtype, device=device))

    @staticmethod
    def from_data(x: torch.Tensor) -> "Domain":
        """Map [min(x), max(x)] -> [-1, 1], one min/max over the WHOLE
        array (not per series); a degenerate range keeps scale 1."""
        lo = torch.min(x)
        hi = torch.max(x)
        shift = (hi + lo) / 2.0
        half = (hi - lo) / 2.0
        one = torch.ones_like(half)
        scale = torch.where(half > 0, one / torch.where(half > 0, half, one),
                            one)
        return Domain(shift.to(x.dtype), scale.to(x.dtype))

    @staticmethod
    def choose(x: torch.Tensor, *, normalize: bool, pinned=None,
               from_data=None) -> "Domain":
        """A fit's domain: ``pinned`` when one is pinned; else, under
        ``normalize``, ``from_data(x)`` (by default ``Domain.from_data``);
        else the identity in x's dtype on x's device.  x is read only when
        nothing is pinned."""
        if pinned is not None:
            return pinned
        if normalize:
            return (from_data or Domain.from_data)(x)
        return Domain.identity(x.dtype, x.device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """``(x - shift) * scale`` with one temporary the size of x: the
        difference is scaled in place (the same operations, the same
        bits)."""
        return torch.sub(x, self.shift).mul_(self.scale)


def vandermonde(x: torch.Tensor, degree: int,
                basis: str = MONOMIAL) -> torch.Tensor:
    """Design matrix V with shape ``x.shape + (degree + 1,)``.

    Powers are built by iterated multiplication, never ``pow`` (the
    paper's CUDA kernel does the same)."""
    if basis not in _BASES:
        raise ValueError(f"unknown basis {basis!r}; expected one of {_BASES}")
    if degree < 0:
        raise ValueError("degree must be >= 0")
    cols = [torch.ones_like(x)]
    if degree >= 1:
        cols.append(x)
    if basis == MONOMIAL:
        for _ in range(2, degree + 1):
            cols.append(cols[-1] * x)
    else:
        for _ in range(2, degree + 1):
            cols.append(2.0 * x * cols[-1] - cols[-2])
    return torch.stack(cols, dim=-1)


def evaluate(coeffs: torch.Tensor, x: torch.Tensor, *,
             degree: int | None = None, basis: str = MONOMIAL,
             domain: Domain | None = None) -> torch.Tensor:
    """Evaluate a fitted polynomial at x; coeffs[..., k] multiplies basis k.

    Horner for monomials, Clenshaw for Chebyshev.  Batched coefficients
    (..., m+1) broadcast against x (..., n) on a new axis."""
    deg = (coeffs.shape[-1] - 1) if degree is None else degree
    if domain is not None:
        x = domain.apply(x)
    if coeffs.ndim > 1:
        def c(k):
            return coeffs[..., k, None]
    else:
        def c(k):
            return coeffs[..., k]
    if basis == MONOMIAL:
        acc = torch.zeros_like(x) + c(deg)
        for k in range(deg - 1, -1, -1):
            acc = acc * x + c(k)
        return acc
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(deg, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + c(k), b1
    return x * b1 - b2 + c(0)


def monomial_coeffs_from_domain(coeffs: torch.Tensor, domain: Domain,
                                degree: int) -> torch.Tensor:
    """Coefficients fitted on t = scale*(x-shift) (monomial basis) back to
    raw-x monomial coefficients.  Host-side binomial expansion in float64
    numpy (small m)."""
    c = coeffs.detach().cpu().double().numpy()
    s = float(domain.scale)
    h = float(domain.shift)
    out = np.zeros(degree + 1, dtype=np.float64)
    for k in range(degree + 1):
        for j in range(k + 1):
            out[j] += c[k] * (s ** k) * comb(k, j) * ((-h) ** (k - j))
    return torch.as_tensor(out).to(device=coeffs.device, dtype=coeffs.dtype)
