"""FitPlan — the one place that decides HOW a fit executes (port of
``repro.engine.plan``).

Paths (``FitPlan.path``):

* ``reference``      plain PyTorch ``core.moments.gram_moments``;
* ``kernel_plain``   the one-series CUDA moment kernel;
* ``kernel_packed``  the many-series CUDA moment kernel.

Selection heuristics, as in the reference:

* non-monomial bases and degree+2 > 128 always take ``reference``;
* off CUDA, ``auto`` always takes ``reference`` (the kernels run only on
  the card; their plain versions are test oracles, not a fast path);
* on CUDA, a batch of ≥ PACKED_MIN_BATCH series with packing room takes
  ``kernel_packed``;
* on CUDA, a single series takes ``kernel_plain`` past
  ``KERNEL_MIN_POINTS`` points;
* everything else stays ``reference``;
* the ``lspia`` workload (matrix-free V/Vᵀ sweeps, no Gram) always takes
  ``reference``.

``backend=`` overrides the device's type for what-if planning ("cuda" is
the accelerator, where the reference says "tpu").
"""
from __future__ import annotations

import dataclasses
import math
import threading
import warnings
from typing import Any

import torch

from repro_torch.obs import spans

# path names (FitPlan.path)
REFERENCE = "reference"
KERNEL_PLAIN = "kernel_plain"
KERNEL_PACKED = "kernel_packed"
PATHS = (REFERENCE, KERNEL_PLAIN, KERNEL_PACKED)

ENGINES = ("auto", "reference", "kernel", "kernel_plain", "kernel_packed")

# These two crossovers were chosen for the TPU and keep its values; they
# are to be re-measured on the H100.
PACKED_MIN_BATCH = 2          # packed needs >= 2 series to beat plain
KERNEL_MIN_POINTS = 1 << 15   # single-series crossover (total points)

SOLVERS = ("auto", "gauss", "cholesky", "qr", "svd", "lspia")

# solver="auto" turns domain normalization on for raw-monomial fits at
# these degrees (a wide-domain Gram past them is beyond every solver)
AUTO_NORMALIZE_DEGREE_F32 = 6
AUTO_NORMALIZE_DEGREE_F64 = 8


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    """Numerical-robustness knobs, decided once per fit.

    ``accum_dtype=None`` accumulates in the input dtype on the reference
    path and in float32 on the kernel paths."""

    accum_dtype: Any = None
    compensated: bool = False      # Kahan-compensated accumulation
    normalize: bool = False        # map the sample domain to [-1, 1]
    solver: str = "gauss"          # resolved primary normal-equation solver
    fallback: str | None = "svd"   # condition-triggered rescue (None = off)
    cond_cap: float | None = None  # κ threshold (None = dtype default)


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """A fully-resolved execution plan for one moment-accumulation problem."""

    path: str                      # one of PATHS
    degree: int
    basis: str
    batch: tuple[int, ...]         # leading batch shape of x/y
    n: int                         # series length (last axis)
    weighted: bool
    numerics: NumericsPolicy
    distributed: bool = False      # one shard of a mesh fit (all-reduced)
    devices: int = 1               # mesh size over the data axes
    reason: str = ""               # human-readable why (logs / tests)

    @property
    def uses_kernel(self) -> bool:
        return self.path in (KERNEL_PLAIN, KERNEL_PACKED)

    @property
    def packing(self) -> str:
        """ops.moments packing= argument for this plan."""
        return "packed" if self.path == KERNEL_PACKED else "plain"

    def describe(self) -> str:
        shard = f" x{self.devices}shards" if self.distributed else ""
        return (f"FitPlan[{self.path}{shard}] deg={self.degree} "
                f"basis={self.basis} batch={self.batch} n={self.n} "
                f"accum={self.numerics.accum_dtype} "
                f"kahan={self.numerics.compensated} "
                f"norm={self.numerics.normalize} ({self.reason})")


def _packing_factor(degree: int) -> int:
    from repro_torch.kernels import moments as kernel
    return kernel.packing_factor(degree)


def _kernel_degree_ok(degree: int) -> bool:
    from repro_torch.kernels import moments as kernel
    return degree + 2 <= kernel.K_PAD


def _autonorm_degree(dtype: Any) -> int:
    try:
        f64 = torch.finfo(dtype).eps < 1e-9
    except TypeError:
        f64 = False
    return AUTO_NORMALIZE_DEGREE_F64 if f64 else AUTO_NORMALIZE_DEGREE_F32


def resolve_numerics(degree: int, *, basis: str = "monomial",
                     dtype: Any = torch.float32,
                     accum_dtype: Any = None,
                     normalize: bool = False,
                     compensated: bool = False,
                     solver: str = "auto",
                     fallback: str | None = "svd",
                     cond_cap: float | None = None) -> NumericsPolicy:
    """Resolve solver="auto" + auto-normalization into a concrete policy:
    normalize raw-monomial fits at high degree, pick the static solver
    rung, and leave the runtime guard to the solve."""
    from repro_torch.core import solve as solve_lib
    if solver == "qr_vandermonde":
        raise ValueError(
            "solver='qr_vandermonde' factors the raw Vandermonde rows and "
            "cannot run from moments; use core.polyfit(..., "
            "solver='qr_vandermonde') or api.FitSpec(numerics="
            "NumericsPolicy(solver='qr_vandermonde')) with api.fit")
    if solver not in SOLVERS:
        raise ValueError(f"solver={solver!r}; expected one of {SOLVERS}")
    if solver == "lspia":
        raise ValueError(
            "solver='lspia' needs the raw data (matrix-free V/Vᵀ sweeps); "
            "moment-based solves only take the explicit ladder "
            f"{solve_lib.SOLVERS} or 'auto'")
    if fallback is not None and fallback not in solve_lib.SOLVERS:
        raise ValueError(f"fallback={fallback!r}; expected one of "
                         f"{solve_lib.SOLVERS} or None")
    if solver == "auto":
        if (basis == "monomial" and not normalize
                and degree >= _autonorm_degree(dtype)):
            normalize = True
        solver = solve_lib.select_solver(degree, dtype, basis=basis,
                                         normalized=normalize)
    return NumericsPolicy(accum_dtype=accum_dtype, compensated=compensated,
                          normalize=normalize, solver=solver,
                          fallback=fallback, cond_cap=cond_cap)


def resolve_engine(engine: str, use_kernel: bool | None) -> str:
    """Fold the deprecated ``use_kernel`` boolean into ``engine=``."""
    if use_kernel is not None:
        warnings.warn(
            "use_kernel= is deprecated; pass engine='kernel' / "
            "engine='reference' (or leave engine='auto')",
            DeprecationWarning, stacklevel=3)
        mapped = "kernel" if use_kernel else "reference"
        if engine not in ("auto", mapped):
            raise ValueError(
                f"conflicting engine={engine!r} and use_kernel={use_kernel} "
                f"(the deprecated alias means engine={mapped!r}); drop "
                "use_kernel=")
        return mapped
    return engine


@spans.span("fit.plan")
def plan_fit(shape: tuple[int, ...], degree: int, *,
             basis: str = "monomial",
             dtype: Any = torch.float32,
             weighted: bool = False,
             engine: str = "auto",
             accum_dtype: Any = None,
             normalize: bool = False,
             compensated: bool = False,
             solver: str = "auto",
             fallback: str | None = "svd",
             cond_cap: float | None = None,
             device: torch.device | str | None = None,
             backend: str | None = None,
             mesh=None,
             data_axes: tuple[str, ...] = (),
             workload: str = "moments") -> FitPlan:
    """Resolve an execution path + numerics policy from static problem
    facts.  ``device`` is where the data lives; ``backend`` ("cuda" or
    "cpu") overrides its type for what-if planning.  ``mesh``/
    ``data_axes``: the ``DeviceMesh`` of a distributed fit; ``shape`` is
    then one rank's shard shape and the plan is marked distributed.
    ``workload`` is "moments", "select" (the degree-sweep accumulation of
    ``select/``, routed exactly like "moments": its fold axis is an
    ordinary series batch, so the packed kernel takes it on CUDA; the
    numerics are resolved at the MAX candidate degree, where conditioning
    is worst),
    "report" (the fused evaluate/residual pass, which monomial fits take
    on every backend, as in the reference) or "lspia" (the matrix-free
    iterative fit: no Gram at all, always the reference basis ops)."""
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}; expected one of {ENGINES}")
    if workload not in ("moments", "select", "report", "lspia"):
        raise ValueError(f"workload={workload!r}")
    if not shape:
        raise ValueError("x/y must have at least one (series) axis")
    batch = tuple(int(s) for s in shape[:-1])
    n = int(shape[-1])
    b = math.prod(batch)
    if backend is None:
        backend = torch.device(device).type if device is not None else "cpu"
    if workload == "lspia":
        # the matrix-free workload has no normal-equation solve to plan
        numerics = NumericsPolicy(accum_dtype=accum_dtype,
                                  compensated=compensated,
                                  normalize=normalize, solver="lspia",
                                  fallback=None, cond_cap=cond_cap)
    else:
        numerics = resolve_numerics(degree, basis=basis, dtype=dtype,
                                    accum_dtype=accum_dtype,
                                    normalize=normalize,
                                    compensated=compensated, solver=solver,
                                    fallback=fallback, cond_cap=cond_cap)
    devices = 1
    if mesh is not None:
        for ax in data_axes:
            devices *= mesh.size(mesh.mesh_dim_names.index(ax))
    common = dict(degree=degree, basis=basis, batch=batch, n=n,
                  weighted=weighted, numerics=numerics,
                  distributed=devices > 1, devices=devices)

    monomial = basis == "monomial"
    if engine in ("kernel", "kernel_plain", "kernel_packed"):
        if not monomial:
            raise ValueError(
                f"engine={engine!r} supports the monomial basis only (the "
                f"kernels build monomial power rows); use "
                f"engine='reference' or 'auto' for basis={basis!r}")
        if not _kernel_degree_ok(degree):
            raise ValueError(f"degree {degree} exceeds the kernel tile "
                             "(degree + 2 must be <= 128)")

    if workload == "lspia":
        # matrix-free: basis matvecs only, no Gram to accumulate (a forced
        # kernel engine was validated above all the same)
        return FitPlan(path=REFERENCE, reason="lspia: matrix-free basis "
                       "matvecs (never forms the Gram)", **common)

    if workload == "report":
        if engine == "reference" or not monomial:
            return FitPlan(path=REFERENCE, reason="report: materializing "
                           "torch pass (forced or non-monomial)", **common)
        return FitPlan(path=KERNEL_PLAIN, reason="report: fused one-pass "
                       "kernel (only one-pass option)", **common)

    if engine == "reference":
        return FitPlan(path=REFERENCE, reason="forced", **common)
    if engine == "kernel_plain":
        return FitPlan(path=KERNEL_PLAIN, reason="forced", **common)
    if engine == "kernel_packed":
        if _packing_factor(degree) < 2:
            raise ValueError(f"degree {degree} leaves no room to pack "
                             f"(packing_factor={_packing_factor(degree)})")
        return FitPlan(path=KERNEL_PACKED, reason="forced", **common)
    if engine == "kernel":
        if b >= PACKED_MIN_BATCH and _packing_factor(degree) >= 2:
            return FitPlan(path=KERNEL_PACKED,
                           reason=f"forced kernel; batch {b} packs "
                           f"{_packing_factor(degree)}/tile", **common)
        return FitPlan(path=KERNEL_PLAIN,
                       reason="forced kernel; no packing room", **common)

    # ---- auto -----------------------------------------------------------
    if not monomial:
        return FitPlan(path=REFERENCE, reason=f"auto: basis={basis} has no "
                       "kernel", **common)
    if not _kernel_degree_ok(degree):
        return FitPlan(path=REFERENCE,
                       reason=f"auto: degree {degree} > kernel tile",
                       **common)
    if backend != "cuda":
        return FitPlan(path=REFERENCE, reason=f"auto: backend={backend} "
                       "(the kernels run on CUDA only)", **common)
    if b >= PACKED_MIN_BATCH and _packing_factor(degree) >= 2:
        return FitPlan(path=KERNEL_PACKED,
                       reason=f"auto: batch {b} packs "
                       f"{_packing_factor(degree)} series/tile", **common)
    if b * n >= KERNEL_MIN_POINTS:
        return FitPlan(path=KERNEL_PLAIN,
                       reason=f"auto: {b * n} pts >= crossover "
                       f"{KERNEL_MIN_POINTS}", **common)
    return FitPlan(path=REFERENCE,
                   reason=f"auto: {b * n} pts below kernel crossover",
                   **common)


# counter on moment-producing calls: every compute_moments invocation, the
# points it touches (the one-data-pass contract of degree selection is
# asserted against it) and the calls handed a weight array; the lock keeps
# it exact when fleet workers pump in threads
_MOMENT_COUNTER = {"calls": 0, "points": 0, "weighted": 0}
_MOMENT_COUNTER_LOCK = threading.Lock()


def reset_moment_counter() -> None:
    with _MOMENT_COUNTER_LOCK:
        for k in _MOMENT_COUNTER:
            _MOMENT_COUNTER[k] = 0


def moment_counter() -> dict:
    """Snapshot of the moment-pass counter: {"calls": int, "points": int,
    "weighted": int}, ``weighted`` the calls handed a weight array."""
    with _MOMENT_COUNTER_LOCK:
        return dict(_MOMENT_COUNTER)


# counter on the mesh executor's all-reduces: calls and payload bytes in
# all, and calls per reduction ("sum", "min", "max"); the distributed
# fit's O(m²) payload, the same at any n, is asserted against it
_COLLECTIVE_COUNTER = {"calls": 0, "bytes": 0, "sum": 0, "min": 0, "max": 0}
_COLLECTIVE_COUNTER_LOCK = threading.Lock()


def record_collective(op: str, nbytes: int) -> None:
    """Count one all-reduce of ``nbytes`` payload bytes under ``op``."""
    with _COLLECTIVE_COUNTER_LOCK:
        _COLLECTIVE_COUNTER["calls"] += 1
        _COLLECTIVE_COUNTER["bytes"] += int(nbytes)
        _COLLECTIVE_COUNTER[op] += 1


def reset_collective_counter() -> None:
    with _COLLECTIVE_COUNTER_LOCK:
        for k in _COLLECTIVE_COUNTER:
            _COLLECTIVE_COUNTER[k] = 0


def collective_counter() -> dict:
    """Snapshot of the all-reduce counter: {"calls", "bytes", "sum",
    "min", "max"}."""
    with _COLLECTIVE_COUNTER_LOCK:
        return dict(_COLLECTIVE_COUNTER)


@spans.span("fit.moments")
def compute_moments(plan: FitPlan, x: torch.Tensor, y: torch.Tensor,
                    weights: torch.Tensor | None = None, *, domain=None):
    """Execute a plan's moment accumulation.  Returns ``core.Moments``.

    Without ``domain``, ``x`` must already be domain-mapped if
    ``plan.numerics.normalize``.  With a ``core.Domain``, ``x`` is raw and
    the result is the moments of ``domain.apply(x)``, bit for bit: a kernel
    plan maps each x value as the kernel loads it (no mapped copy of x is
    made), the reference path maps x first."""
    with _MOMENT_COUNTER_LOCK:
        _MOMENT_COUNTER["calls"] += 1
        _MOMENT_COUNTER["points"] += math.prod(x.shape)
        _MOMENT_COUNTER["weighted"] += weights is not None
    if plan.uses_kernel:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.moments(
            x, y, plan.degree, weights=weights,
            accum_dtype=plan.numerics.accum_dtype, packing=plan.packing,
            compensated=plan.numerics.compensated, domain=domain,
            device=x.device)
    if domain is not None:
        x = domain.apply(x)
    from repro_torch.core import moments as moments_lib
    return moments_lib.gram_moments(
        x, y, plan.degree, basis=plan.basis, weights=weights,
        accum_dtype=plan.numerics.accum_dtype)


def compute_report_sums(plan: FitPlan, x: torch.Tensor, y: torch.Tensor,
                        coeffs: torch.Tensor,
                        weights: torch.Tensor | None = None) -> dict:
    """Execute a ``workload="report"`` plan: the seven sums (Σw, Σwy, Σwy²,
    Σwf, Σwf², Σwyf, Σwe²).  ``x`` must already be domain-mapped."""
    if plan.uses_kernel:
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.fused_report_sums(x, y, coeffs, weights=weights,
                                            device=x.device)
    from repro_torch.core import basis as basis_lib
    fitted = basis_lib.evaluate(coeffs, x, basis=plan.basis)
    w = torch.ones_like(y) if weights is None else weights
    e = y - fitted
    return {"sw": torch.sum(w, dim=-1),
            "sy": torch.sum(w * y, dim=-1),
            "syy": torch.sum(w * y * y, dim=-1),
            "sf": torch.sum(w * fitted, dim=-1),
            "sff": torch.sum(w * fitted * fitted, dim=-1),
            "syf": torch.sum(w * y * fitted, dim=-1),
            "sse": torch.sum(w * e * e, dim=-1)}
