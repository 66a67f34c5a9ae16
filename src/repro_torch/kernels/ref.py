"""Plain PyTorch oracles for the moment kernels (port of
``repro.kernels.ref``).

The extended Gram is G = (W·w) Wᵀ with W = [V | y | 0-pad], W: (K_PAD, n)
row-major powers — the TPU kernel's raw output, including the K_PAD=128
zero padding, so tests can compare the full padded tile as well as the
extracted Moments."""
from __future__ import annotations

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core.moments import Moments

K_PAD = 128  # the TPU kernel's fixed row count (degree+2 <= K_PAD)


def extended_matrix(x: torch.Tensor, y: torch.Tensor, degree: int,
                    accum_dtype=torch.float32) -> torch.Tensor:
    """W rows: [x^0, ..., x^degree, y, zeros...]; shape (..., K_PAD, n).

    Inputs are cast to ``accum_dtype`` BEFORE the power ladder, as the
    kernels do."""
    x = x.to(accum_dtype)
    y = y.to(accum_dtype)
    v = basis_lib.vandermonde(x, degree)                  # (..., n, m+1)
    w = torch.cat([v, y[..., :, None]], dim=-1)           # (..., n, m+2)
    w = torch.nn.functional.pad(w, (0, K_PAD - (degree + 2)))
    return w.transpose(-1, -2)                            # (..., K_PAD, n)


def extended_gram(x: torch.Tensor, y: torch.Tensor, degree: int,
                  weights: torch.Tensor | None = None,
                  accum_dtype=torch.float32) -> torch.Tensor:
    """(..., K_PAD, K_PAD) reference for the kernel's raw output."""
    w_mat = extended_matrix(x, y, degree, accum_dtype)
    lhs = (w_mat if weights is None
           else w_mat * weights[..., None, :].to(accum_dtype))
    return torch.einsum("...kn,...jn->...kj", lhs, w_mat)


def moments_from_extended(g: torch.Tensor, degree: int,
                          count: torch.Tensor | None = None) -> Moments:
    """Slice the paper's statistics out of the extended Gram matrix
    (G[0,0] is Σw; pass the true count when weights are in play)."""
    m1 = degree + 1
    return Moments(gram=g[..., :m1, :m1], vty=g[..., :m1, m1],
                   yty=g[..., m1, m1],
                   count=g[..., 0, 0] if count is None else count,
                   weight_sum=g[..., 0, 0])


def moments_reference(x: torch.Tensor, y: torch.Tensor, degree: int,
                      weights: torch.Tensor | None = None,
                      accum_dtype=torch.float32) -> Moments:
    count = None
    if weights is not None:
        count = torch.sum(weights != 0, dim=-1).to(accum_dtype)
    return moments_from_extended(
        extended_gram(x, y, degree, weights, accum_dtype), degree,
        count=count)


def packed_extended_gram(x: torch.Tensor, y: torch.Tensor, degree: int,
                         weights: torch.Tensor | None = None,
                         accum_dtype=torch.float32) -> torch.Tensor:
    """Oracle for the TPU packed kernel's raw (G, K_PAD, K_PAD) output.

    x, y (and weights): (G, P, n) with P = K_PAD // (degree+2); series p's
    K×K extended Gram is the p-th diagonal block, and the cross-series
    off-diagonal blocks are included."""
    g, p, n = x.shape
    k = degree + 2
    x = x.to(accum_dtype)
    y = y.to(accum_dtype)
    v = basis_lib.vandermonde(x, degree)                  # (G, P, n, m+1)
    w = torch.cat([v, y[..., :, None]], dim=-1)           # (G, P, n, K)
    w = w.transpose(-1, -2).reshape(g, p * k, n)          # (G, P*K, n)
    w = torch.nn.functional.pad(w, (0, 0, 0, K_PAD - p * k))
    if weights is None:
        lhs = w
    else:
        wexp = torch.repeat_interleave(weights.to(accum_dtype), k, dim=1)
        wexp = torch.nn.functional.pad(wexp, (0, 0, 0, K_PAD - p * k))
        lhs = w * wexp
    return torch.einsum("gkn,gjn->gkj", lhs, w)
