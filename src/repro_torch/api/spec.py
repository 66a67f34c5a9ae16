"""FitSpec — one declarative, validated description of a fit (port of
``repro.api.spec``).

One frozen, hashable spec consumed unchanged by four executors:

* ``api.fit(x, y, spec)``          eager;
* ``spec.streaming()``             an O(1)-state ``StreamState`` wired to
                                   the spec (chunk updates + result);
* ``spec.distributed(mesh)``       a mesh executor over
                                   ``torch.distributed`` ranks: each rank
                                   passes its block, all get the result;
* ``serve.FitServeEngine.submit(x, y, spec=...)``  per-request policy on
                                   the fit server (and on the fleet, with
                                   a ``ServicePolicy`` beside it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import basis as basis_lib
from repro_torch.engine import plan as plan_lib
from repro_torch.select.sweep import DegreeSearch, Selection

METHODS = ("lse", "irls", "lspia")
_LOSSES = ("huber", "tukey")

# solver spellings that need the raw data (no moment-space equivalent):
# valid in a FitSpec consumed by the eager executor only.
RAW_DATA_SOLVERS = ("qr_vandermonde",)


@dataclasses.dataclass(frozen=True)
class IRLSOptions:
    """Options for ``method="irls"`` (bounded-influence IRLS)."""

    loss: str = "huber"
    c: float | None = None
    max_iter: int = 30
    tol: float = 1e-6
    stream_sweeps: int = 3

    def __post_init__(self):
        if self.loss not in _LOSSES:
            raise ValueError(f"loss={self.loss!r}; expected one of {_LOSSES}")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.stream_sweeps < 1:
            raise ValueError("stream_sweeps must be >= 1, got "
                             f"{self.stream_sweeps}")


@dataclasses.dataclass(frozen=True)
class LSPIAOptions:
    """Options for ``method="lspia"`` (progressive-iterative approximation).

    The eager executor runs the matrix-free V/Vᵀ iteration
    (``core.lspia.lspia_fit_spec``); moment-only surfaces (streaming,
    serving) run the same fixed point as Richardson iteration on the
    accumulated normal equations (``core.lspia.lspia_solve_moments``).
    ``momentum`` is the heavy-ball term β·(cₖ − cₖ₋₁); ``staleness`` is
    read by the asynchronous distributed executor only."""

    tol: float = 1e-8
    max_iter: int = 5000
    power_iters: int = 12
    step: float | None = None
    momentum: float = 0.0
    staleness: int = 4

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.power_iters < 1:
            raise ValueError("power_iters must be >= 1, got "
                             f"{self.power_iters}")
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError("momentum must lie in [0, 1) (heavy-ball "
                             f"stability), got {self.momentum}")
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {self.staleness}")


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """Per-request serving policy: how hard the fleet fights for this fit.

    Attached at submission (``fleet.submit(x, y, spec=..., service=...)``)
    rather than inside ``FitSpec``: the *fitting question* is transport-
    free, while retry/deadline/hedging describe how one particular
    submission rides the fault-tolerant fleet (``repro_torch.serve.fleet``).

    ``retry_timeout`` is the no-progress window (virtual ticks) before a
    chunk or solve message is resent to the same worker; ``max_retries``
    bounds resends *and* cross-worker replays per request before it is
    failed; ``hedge`` opts the request into duplicate dispatch when its
    worker is verdicted a straggler; ``deadline`` (ticks from admission,
    ``None`` = never) fails the request outright when serving takes too
    long — the caller prefers an error over a stale answer."""

    max_retries: int = 4
    retry_timeout: int = 8
    hedge: bool = True
    deadline: int | None = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.retry_timeout < 1:
            raise ValueError(f"retry_timeout must be >= 1, got "
                             f"{self.retry_timeout}")
        if self.deadline is not None and self.deadline < 1:
            raise ValueError(f"deadline must be >= 1 (or None), got "
                             f"{self.deadline}")


def _as_domain_tuple(domain) -> tuple[float, float] | None:
    """Normalize a Domain / (shift, scale) pair to a hashable float tuple."""
    if domain is None:
        return None
    if isinstance(domain, basis_lib.Domain):
        return (float(domain.shift), float(domain.scale))
    shift, scale = domain
    return (float(shift), float(scale))


@dataclasses.dataclass(frozen=True)
class FitSpec:
    """The whole fitting question, validated once, hashable.

    degree: an int (fixed-degree fit) or a ``select.DegreeSearch`` (one-pass
    selection over the ladder 0..max_degree).  basis: "monomial" |
    "chebyshev".
    method: "lse" | "irls" | "lspia".  domain: None (the numerics policy
    decides) or a pinned ``(shift, scale)`` map.  numerics: the solver /
    fallback / accumulation policy.  decay: exponential forgetting
    γ ∈ (0, 1].  ridge: λI added to the Gram at solve time.  engine: the
    moment-accumulation path, resolved by ``engine.plan_fit``."""

    degree: int | DegreeSearch = 3
    basis: str = basis_lib.MONOMIAL
    method: str = "lse"
    irls: IRLSOptions = IRLSOptions()
    lspia: LSPIAOptions = LSPIAOptions()
    domain: tuple[float, float] | None = None
    numerics: plan_lib.NumericsPolicy = plan_lib.NumericsPolicy(solver="auto")
    decay: float = 1.0
    ridge: float = 0.0
    engine: str = "auto"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method={self.method!r}; expected one of "
                             f"{METHODS}")
        if self.basis not in (basis_lib.MONOMIAL, basis_lib.CHEBYSHEV):
            raise ValueError(f"basis={self.basis!r}; expected "
                             f"{(basis_lib.MONOMIAL, basis_lib.CHEBYSHEV)}")
        if self.engine not in plan_lib.ENGINES:
            raise ValueError(f"engine={self.engine!r}; expected one of "
                             f"{plan_lib.ENGINES}")
        object.__setattr__(self, "domain", _as_domain_tuple(self.domain))
        if isinstance(self.degree, DegreeSearch):
            if self.degree.max_degree < 0:
                raise ValueError("DegreeSearch.max_degree must be >= 0")
            if self.method == "lspia":
                raise ValueError(
                    "method='lspia' cannot run a DegreeSearch: the degree "
                    "ladder lives in the moment state, which LSPIA never "
                    "forms; fit per degree or use method='lse'/'irls'")
            if self.numerics.solver in RAW_DATA_SOLVERS:
                raise ValueError(
                    f"solver={self.numerics.solver!r} has no moment-space "
                    "ladder and cannot drive a DegreeSearch")
        else:
            degree = int(self.degree)
            if degree < 0:
                raise ValueError(f"degree must be >= 0, got {degree}")
            object.__setattr__(self, "degree", degree)
        sol = self.numerics.solver
        if sol == "lspia":
            raise ValueError("spell the iterative method as "
                             "FitSpec(method='lspia'), not as a solver")
        valid = plan_lib.SOLVERS + RAW_DATA_SOLVERS
        if sol not in valid:
            raise ValueError(f"solver={sol!r}; expected one of {valid}")
        if sol in RAW_DATA_SOLVERS and self.method != "lse":
            raise ValueError(f"solver={sol!r} is an LSE direct solve; "
                             f"method={self.method!r} cannot use it")
        if sol in RAW_DATA_SOLVERS and self.ridge:
            raise ValueError(
                f"solver={sol!r} factors the raw rows and has no λI to "
                "add — ridge regularization is a normal-equation concept; "
                "drop ridge= or use a moment-path solver")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")
        if self.ridge < 0.0:
            raise ValueError(f"ridge must be >= 0, got {self.ridge}")
        if (self.engine in ("kernel", "kernel_plain", "kernel_packed")
                and self.basis != basis_lib.MONOMIAL):
            raise ValueError(
                f"engine={self.engine!r} supports the monomial basis only "
                f"(the kernels build monomial power rows); use "
                f"engine='reference' or 'auto' for basis={self.basis!r}")

    @property
    def is_search(self) -> bool:
        return isinstance(self.degree, DegreeSearch)

    @property
    def max_degree(self) -> int:
        """The accumulation degree: the fixed degree, or the search's max."""
        return (self.degree.max_degree if self.is_search
                else int(self.degree))

    @property
    def folds(self) -> int:
        return self.degree.folds if self.is_search else 0

    def domain_or(self, default: basis_lib.Domain | None = None,
                  dtype=torch.float32, device=None):
        """The pinned Domain as tensors, or ``default`` when unpinned."""
        if self.domain is None:
            return default
        shift, scale = self.domain
        return basis_lib.Domain(
            torch.tensor(shift, dtype=dtype, device=device),
            torch.tensor(scale, dtype=dtype, device=device))

    def plan(self, shape: tuple[int, ...], dtype: Any, *,
             weighted: bool = False, workload: str = "moments",
             device=None, mesh=None, data_axes: tuple[str, ...] = ()):
        """Lower this spec through ``engine.plan_fit`` (``mesh``/
        ``data_axes``: ``shape`` is one rank's shard of a mesh fit)."""
        pol = self.numerics
        solver = "auto" if pol.solver in RAW_DATA_SOLVERS else pol.solver
        return plan_lib.plan_fit(
            shape, self.max_degree, basis=self.basis, dtype=dtype,
            weighted=weighted or self.decay < 1.0, engine=self.engine,
            accum_dtype=pol.accum_dtype, normalize=pol.normalize,
            compensated=pol.compensated, solver=solver,
            fallback=pol.fallback, cond_cap=pol.cond_cap, device=device,
            mesh=mesh, data_axes=data_axes, workload=workload)

    def streaming(self, batch: tuple[int, ...] = (), *, dtype=None,
                  device=None):
        """An O(1)-state ``StreamState`` wired to this spec on ``device``
        (``None`` means CUDA).  Chunk data in with
        ``core.streaming.update(state, x, y)``; read the answer back with
        ``api.stream_result(state)``."""
        from repro_torch.api import executors
        return executors.stream_state(self, batch, dtype=dtype,
                                      device=device)

    def distributed(self, mesh, *, data_axes: tuple[str, ...] = ("data",)):
        """A mesh executor for this spec: ``fn(x, y, weights=None) ->
        FitResult``, called on every rank with that rank's block of the
        series (``core.distributed``), the result replicated."""
        from repro_torch.api import executors
        return executors.make_distributed(self, mesh, data_axes=data_axes)


@dataclasses.dataclass(frozen=True)
class FitResult:
    """What every executor hands back: ``poly`` (ready to evaluate,
    carrying its basis and Domain); ``report``, the moment-space quality
    report (SSE/R/count) where the surface holds the moments; ``selection``,
    the scored ladder of a DegreeSearch; ``iterations`` / ``converged``,
    the loop record of IRLS and LSPIA."""

    poly: Any
    report: Any = None
    selection: Selection | None = None
    iterations: Any = None
    converged: Any = None

    @property
    def coeffs(self):
        return self.poly.coeffs

    @property
    def diagnostics(self):
        return self.poly.diagnostics

    @property
    def best_degree(self):
        return None if self.selection is None else self.selection.best_degree
