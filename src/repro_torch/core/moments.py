"""Matricized moment / Gram accumulation (port of ``repro.core.moments``).

The normal-equation matrix is the Hankel matrix of power sums
``A[j,k] = Σ x^{j+k}`` and the right-hand side ``B[j] = Σ x^j y``; with the
Vandermonde matrix V these are ``A = VᵀV`` and ``B = Vᵀy``.  Moments are
additive across data shards and across time.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import basis as basis_lib


@dataclasses.dataclass(frozen=True)
class Moments:
    """Sufficient statistics of an LSE fit.  Additive: m1 + m2 fits the union.

    ``count`` is the TRUE number of contributing points (nonzero weight,
    padding excluded) on every producing path; the weighted mass Σw lives
    in ``weight_sum``."""

    gram: torch.Tensor        # (..., m+1, m+1)  == Vᵀ V
    vty: torch.Tensor         # (..., m+1)       == Vᵀ y
    yty: torch.Tensor         # (...,)           == Σ w y²
    count: torch.Tensor       # (...,)           == # points with nonzero weight
    weight_sum: torch.Tensor  # (...,)           == Σ w

    def __add__(self, other: "Moments") -> "Moments":
        return Moments(self.gram + other.gram, self.vty + other.vty,
                       self.yty + other.yty, self.count + other.count,
                       self.weight_sum + other.weight_sum)

    @property
    def degree(self) -> int:
        return self.gram.shape[-1] - 1

    def condition(self) -> torch.Tensor:
        """Estimated κ₂ of the normal-equation matrix (+inf when singular);
        scale-invariant, see ``core.solve.condition_estimate``."""
        from repro_torch.core import solve as solve_lib
        return solve_lib.condition_estimate(self.gram)

    def regularized(self, ridge: float) -> "Moments":
        """Moments with λI added to the Gram (Tikhonov stabilizer)."""
        eye = torch.eye(self.degree + 1, dtype=self.gram.dtype,
                        device=self.gram.device)
        return dataclasses.replace(self, gram=self.gram + ridge * eye)

    def truncate(self, degree: int) -> "Moments":
        """The degree-``degree`` statistics nested inside this state."""
        if not 0 <= degree <= self.degree:
            raise ValueError(f"cannot truncate degree-{self.degree} moments "
                             f"to degree {degree}")
        m1 = degree + 1
        return dataclasses.replace(self, gram=self.gram[..., :m1, :m1],
                                   vty=self.vty[..., :m1])

    @staticmethod
    def zeros(degree: int, batch: tuple[int, ...] = (),
              dtype=torch.float32, device=None) -> "Moments":
        m1 = degree + 1
        batch = tuple(batch)

        def z(shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return Moments(gram=z(batch + (m1, m1)), vty=z(batch + (m1,)),
                       yty=z(batch), count=z(batch), weight_sum=z(batch))


def map_fields(fn, *states: Moments) -> Moments:
    """``fn`` applied field by field across Moments states."""
    return Moments(*(fn(*(getattr(s, f.name) for s in states))
                     for f in dataclasses.fields(Moments)))


def decay_ladder(n: int, decay, dtype, device=None) -> torch.Tensor:
    """``decay ** [n-1, ..., 1, 0]`` — the newest point gets γ⁰."""
    base = torch.as_tensor(decay, dtype=dtype, device=device)
    return base ** torch.arange(n - 1, -1, -1, dtype=dtype, device=device)


def power_sums(x: torch.Tensor, degree: int, *,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Paper-literal power sums S_0..S_{2m} (shape (2*degree+1,))."""
    w = torch.ones_like(x) if weights is None else weights
    sums = []
    p = torch.ones_like(x)
    for _ in range(2 * degree + 1):
        sums.append(torch.sum(p * w))
        p = p * x
    return torch.stack(sums)


def hankel_from_power_sums(s: torch.Tensor, degree: int) -> torch.Tensor:
    """Assemble the paper's A matrix from power sums: A[j,k] = S[j+k]."""
    idx = torch.arange(degree + 1, device=s.device)
    return s[idx[:, None] + idx[None, :]]


def moment_vector(x: torch.Tensor, y: torch.Tensor, degree: int,
                  basis: str = basis_lib.MONOMIAL) -> torch.Tensor:
    """Paper-literal B[j] = Σ x^j y, j = 0..m."""
    v = basis_lib.vandermonde(x, degree, basis)
    return torch.einsum("...nk,...n->...k", v, y)


def gram_moments(x: torch.Tensor, y: torch.Tensor, degree: int, *,
                 basis: str = basis_lib.MONOMIAL,
                 weights: torch.Tensor | None = None,
                 accum_dtype=None) -> Moments:
    """Matricized moments A = VᵀV, B = Vᵀy over the last axis of x/y,
    batched over leading axes; ``accum_dtype`` widens the accumulation."""
    v = basis_lib.vandermonde(x, degree, basis)  # (..., n, m+1)
    if accum_dtype is not None:
        v = v.to(accum_dtype)
        y = y.to(accum_dtype)
    wv = v if weights is None else v * weights[..., :, None]
    # weights wider than accum_dtype promote the sums, as jnp promotes
    # (f64 weights into an f32 stream), instead of failing in einsum
    gram = torch.einsum("...nj,...nk->...jk", wv, v.to(wv.dtype))
    vty = torch.einsum("...nj,...n->...j", wv, y.to(wv.dtype))
    yty = torch.sum((y if weights is None else weights * y) * y, dim=-1)
    if weights is None:
        count = torch.full(x.shape[:-1], x.shape[-1],
                           dtype=accum_dtype or x.dtype, device=x.device)
        weight_sum = count
    else:
        count = torch.sum((weights != 0).to(gram.dtype), dim=-1)
        weight_sum = torch.sum(weights, dim=-1)
    return Moments(gram=gram, vty=vty, yty=yty, count=count.to(gram.dtype),
                   weight_sum=weight_sum.to(gram.dtype))


def gram_moments_blocked(x: torch.Tensor, y: torch.Tensor, degree: int, *,
                         basis: str = basis_lib.MONOMIAL,
                         block: int = 1 << 16,
                         accum_dtype=None) -> Moments:
    """Chunked accumulation for datasets too large to materialize V at
    once: one Gram update per block, the zero-padded tail masked out."""
    n = x.shape[-1]
    out = Moments.zeros(degree, tuple(x.shape[:-1]),
                        dtype=accum_dtype or x.dtype, device=x.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        pad = block - (hi - lo)
        xi = torch.nn.functional.pad(x[..., lo:hi], (0, pad))
        yi = torch.nn.functional.pad(y[..., lo:hi], (0, pad))
        mi = torch.nn.functional.pad(torch.ones_like(x[..., lo:hi]),
                                     (0, pad))
        out = out + gram_moments(xi, yi, degree, basis=basis, weights=mi,
                                 accum_dtype=accum_dtype)
    return out
