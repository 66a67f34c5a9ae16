"""k-fold cross-validation entirely in moment space (port of
``repro.select.crossval``).

Partition the points into K folds (round-robin), accumulate each fold's
``Moments`` in ONE batched accumulation over a (K, ..., n/K) layout (every
point touched once), and then

* the training state of fold j is a subtraction: ``total − fold_j``;
* the held-out score of fold j is ``sse_from_moments(fold_j, coeffs)``.

So K-fold CV over the whole degree ladder costs O(K·m²) state and
O(K·M⁴) tiny solves, independent of n.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import moments as moments_lib



def fold_moments(x: torch.Tensor, y: torch.Tensor, k: int, degree: int, *,
                 weights: torch.Tensor | None = None,
                 basis: str = basis_lib.MONOMIAL, engine: str = "auto",
                 accum_dtype=None, plan=None) -> moments_lib.Moments:
    """Per-fold moment partials with a leading fold axis (k, ..., m+1, m+1).

    Point i goes to fold ``i % k``; the tail is padded with weight 0
    (weights broadcast against x, so a (n,) ladder serves a batch); the
    fold axis rides as a leading batch axis through ONE
    ``compute_moments`` call.  ``x`` must already be domain-mapped.  The
    move of the fold axis to the front makes the kernel's contiguous
    input a transposing copy of x, y and the weights."""
    from repro_torch import engine as engine_lib
    if k < 2:
        raise ValueError(f"k-fold CV needs k >= 2, got {k}")
    n = x.shape[-1]
    nper = -(-n // k)
    pad = nper * k - n
    w = (torch.ones_like(x) if weights is None
         else torch.broadcast_to(weights, x.shape))
    xp = torch.nn.functional.pad(x, (0, pad))
    yp = torch.nn.functional.pad(y, (0, pad))
    wp = torch.nn.functional.pad(w, (0, pad))   # padding weighs 0
    fold_shape = tuple(x.shape[:-1]) + (nper, k)

    def to_folds(a):
        return torch.movedim(a.reshape(fold_shape), -1, 0)

    if plan is None:
        plan = engine_lib.plan_fit(
            (k,) + tuple(x.shape[:-1]) + (nper,), degree, basis=basis,
            dtype=x.dtype, weighted=True, engine=engine,
            accum_dtype=accum_dtype, device=x.device, workload="select")
    return engine_lib.compute_moments(plan, to_folds(xp), to_folds(yp),
                                      to_folds(wp))


def sum_folds(folds: moments_lib.Moments) -> moments_lib.Moments:
    """Collapse the leading fold axis: the total state the sweep solves."""
    return moments_lib.map_fields(lambda a: torch.sum(a, dim=0), folds)


def complement_moments(folds: moments_lib.Moments,
                       total: moments_lib.Moments | None = None
                       ) -> moments_lib.Moments:
    """Training state of every fold at once: ``total − fold_j``."""
    if total is None:
        total = sum_folds(folds)
    return moments_lib.map_fields(lambda t, f: t - f, total, folds)


def cv_scores(folds: moments_lib.Moments, *, solver: str = "auto",
              fallback: str | None = "svd", cond_cap: float | None = None,
              basis: str = basis_lib.MONOMIAL, normalized: bool = False):
    """k-fold held-out SSE (PRESS) and its paired standard error per
    ladder rung, both (..., M+1).

    ``se[d]`` is √k·std (Bessel-corrected) of the per-fold difference
    ``h_j[d] − h_j[argmin]``: the statistic behind the parsimony rule of
    ``criteria.best_degree``."""
    from repro_torch.select import sweep as sweep_lib
    train = complement_moments(folds)
    coeffs, _, _ = sweep_lib.solve_ladder(train, solver=solver,
                                          fallback=fallback,
                                          cond_cap=cond_cap, basis=basis,
                                          normalized=normalized)
    held = fit_lib.sse_from_moments(folds, coeffs)   # (k, ..., M+1)
    k = held.shape[0]
    press = torch.sum(held, dim=0)
    imin = torch.argmin(press, dim=-1)
    hmin = torch.take_along_dim(
        held, imin[None, ..., None].expand(held.shape[:-1] + (1,)), dim=-1)
    diff = held - hmin
    se = torch.std(diff, dim=0, correction=1) * math.sqrt(k)
    return press, se
