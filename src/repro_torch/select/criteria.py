"""Model-selection criteria computed purely from moment-space quantities
(port of ``repro.select.criteria``).

Every criterion is a function of (SSE_d, n, k_d): the per-degree residual
sum of squares, the number of contributing points and the parameter
count k_d = d + 1, plus the degree-free total sum of squares for R².  All
of them come from the O(m²) sufficient statistics alone, so scoring the
whole ladder makes no pass over the data.

* ``sse``   raw Σe², monotone non-increasing in degree, never selects;
* ``r2``    1 − SSE/SST, monotone too, reported for the tables;
* ``aic``   n·ln(SSE/n) + 2k;
* ``aicc``  AIC + 2k(k+1)/(n−k−1), +inf once n ≤ k + 1;
* ``bic``   n·ln(SSE/n) + k·ln(n);
* ``gcv``   (SSE/n) / (1 − k/n)²;
* ``cv``    k-fold held-out SSE (PRESS) from ``select.crossval``.
"""
from __future__ import annotations

import dataclasses

import torch

CRITERIA = ("aic", "aicc", "bic", "gcv", "cv")
MOMENT_CRITERIA = ("aic", "aicc", "bic", "gcv")   # no folds required
REPORTED = ("sse", "r2") + CRITERIA

# "cv" parsimony rule: degrees whose paired held-out deficit against the
# CV minimum is below CV_TCRIT × its paired standard error tie, and the
# smallest wins (the one-SE rule sized as a paired t-test for ~4 dof; see
# the reference module for the measurement behind the value).
CV_TCRIT = 3.0


@dataclasses.dataclass(frozen=True)
class ScoreTable:
    """Per-degree scores, ladder axis last: every field is (..., M+1).

    ``cv`` is the k-fold held-out SSE when fold moments were available,
    else +inf; ``cv_se`` is the paired standard error behind the
    parsimony rule of ``best_degree(..., "cv")``."""

    sse: torch.Tensor
    r2: torch.Tensor
    aic: torch.Tensor
    aicc: torch.Tensor
    bic: torch.Tensor
    gcv: torch.Tensor
    cv: torch.Tensor
    cv_se: torch.Tensor

    @property
    def max_degree(self) -> int:
        return self.sse.shape[-1] - 1

    def by_name(self, criterion: str) -> torch.Tensor:
        if criterion not in REPORTED:
            raise ValueError(f"criterion={criterion!r}; expected one of "
                             f"{REPORTED}")
        return getattr(self, criterion)


def _safe_log_mean_sse(sse: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """ln(SSE/n) with exact-interpolation states clamped to the dtype
    floor instead of -inf."""
    tiny = torch.finfo(sse.dtype).tiny
    return torch.log(torch.clamp(sse, min=tiny) / torch.clamp(n, min=1.0))


def score_table(sse: torch.Tensor, n, sst, cv: torch.Tensor | None = None,
                cv_se: torch.Tensor | None = None) -> ScoreTable:
    """Every criterion for a ladder of SSEs.

    ``sse``: (..., M+1) per-degree residual sums; ``n``: (...,)
    contributing points; ``sst``: (...,) centered total sum of squares;
    ``cv``: optional (..., M+1) held-out SSE.  Degrees whose parameter
    count exhausts the data (n ≤ k, or n ≤ k+1 for AICc) score +inf."""
    m1 = sse.shape[-1]
    dt, dev = sse.dtype, sse.device
    k = torch.arange(1, m1 + 1, dtype=dt, device=dev)
    n = torch.as_tensor(n, dtype=dt, device=dev)[..., None]
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    n1 = torch.clamp(n, min=1.0)
    log_ms = _safe_log_mean_sse(sse, n)
    aic = n * log_ms + 2.0 * k
    dof = n - k - 1.0
    aicc = torch.where(dof > 0, aic + 2.0 * k * (k + 1.0)
                       / torch.where(dof > 0, dof, one), inf)
    bic = n * log_ms + k * torch.log(n1)
    shrink = 1.0 - k / n1
    gcv = torch.where(shrink > 0, (sse / n1)
                      / torch.where(shrink > 0, shrink, one) ** 2, inf)
    underdet = n <= k
    aic = torch.where(underdet, inf, aic)
    bic = torch.where(underdet, inf, bic)
    sst_pos = torch.clamp(torch.as_tensor(sst, dtype=dt, device=dev)[..., None],
                          min=torch.finfo(dt).tiny)
    r2 = 1.0 - sse / sst_pos
    if cv is None:
        cv = torch.full_like(sse, float("inf"))
    if cv_se is None:
        cv_se = torch.zeros_like(sse)
    return ScoreTable(sse=sse, r2=r2, aic=aic, aicc=aicc, bic=bic, gcv=gcv,
                      cv=cv, cv_se=cv_se)


def best_degree(scores: ScoreTable, criterion: str = "aicc") -> torch.Tensor:
    """The selected degree under a criterion over the ladder axis (int32).

    Information criteria take the argmin, ties toward the LOWER degree.
    "cv" takes the smallest degree whose paired held-out deficit against
    the CV minimum is below ``CV_TCRIT`` × its paired standard error."""
    if criterion not in CRITERIA:
        raise ValueError(
            f"criterion={criterion!r} cannot select a degree; pick one of "
            f"{CRITERIA} ('sse'/'r2' are monotone in degree)")
    vals = scores.by_name(criterion)
    if criterion == "cv":
        vmin = torch.amin(vals, dim=-1, keepdim=True)
        within = vals <= vmin + CV_TCRIT * scores.cv_se
        # argmax of a bool tensor is refused: the first True as int8
        return torch.argmax(within.to(torch.int8), dim=-1).to(torch.int32)
    # torch.argmin returns the first of tied minima, as jnp does
    return torch.argmin(vals, dim=-1).to(torch.int32)
