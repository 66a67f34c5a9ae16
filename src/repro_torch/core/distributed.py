"""Distributed matricized LSE fitting over ``torch.distributed`` (port of
``repro.core.distributed``).

**The mesh executor (synchronous).**  The paper parallelizes moment
accumulation across CUDA threads on one GPU; here the same additive
structure is mapped onto a ``DeviceMesh`` of ranks: every rank accumulates
the Gram/moment partials of its own block on its device, one
``all_reduce(SUM)`` per data axis of a single flat buffer holding every
``Moments`` field ((m+1)² + (m+1) + 3 values per series, whatever n is)
combines them, and the tiny (m+1) solve runs replicated on every rank.

``make_spec_executor`` is the one factory: it consumes an ``api.FitSpec``
and builds the mesh program for any method × degree question: plain LSE,
IRLS (one moment all-reduce and one scale all-reduce per sweep; the loop's
stop test reads the replicated coefficients, so every rank takes the same
number of trips), moment-space LSPIA (Richardson on the all-reduced normal
equations) and single-pass degree search (one all-reduce of the (k, m+1,
m+1) fold stack), with weights, decay and the numerics policy riding in
from the spec.  ``make_distributed_fit`` / ``make_distributed_select`` are
the legacy-signature shims that build the spec.

The input contract.  torch has no globally sharded array, so every rank
calls the runner with ITS OWN contiguous block of the global 1-D series
(x, y and the optional weights alike; all blocks of one length).  The
blocks are laid out row-major over ``data_axes``: the rank at mesh
coordinates (i₀, i₁, …) on those axes holds block ((i₀·s₁ + i₁)·s₂ + …),
sᵢ being the axes' sizes.  Ranks that differ only on a non-data axis pass
the same block.  Every rank gets the same, replicated result.  The default
process group must be initialized before the mesh is built
(``launch.mesh``), the data must live on the mesh's device type, and a
NCCL group takes CUDA tensors only; each mismatch raises, and collective
errors are never caught.

**Asynchronous LSPIA: barrier-free shard contributions**
(arXiv:2211.06556).  The mesh executor is a barrier program: every
Richardson sweep waits for the slowest shard's all-reduce.
The asynchronous-LSPIA result says the iteration does not have to wait:
gradient contributions computed against *stale* coefficient versions
still drive it to the same least-squares fixed point as long as the
staleness is bounded.  ``async_lspia_fit`` realizes that on the fleet's
virtual-tick mailbox substrate: one coordinator, N ``AsyncLSPIAShard``
workers (each wrappable by ``runtime.chaos``'s ``ChaosWorker`` — same
protocol as ``serve.fleet``'s workers), per-shard sequence numbers for
idempotent delivery, and a staleness window outside which a shard's delta
is rejected and recomputed.  A chaos-stalled shard therefore delays
CONVERGENCE (its contribution is missing until it catches up) but never
blocks the coordinator's updates.

The async shards' data and their gradients live on one device (``None``
means CUDA); each delta comes back to the host, where the coordinator
keeps the iterate in float64 as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine as engine_lib
from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import lspia as lspia_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import solve as solve_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import spans
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime import straggler as straggler_lib
from repro_torch.runtime.fault_tolerance import FailureDetector

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}


def _axis_size(mesh, ax: str) -> int:
    if ax not in mesh.mesh_dim_names:
        raise ValueError(f"data axis {ax!r} is not an axis of the mesh "
                         f"{mesh.mesh_dim_names}")
    return mesh.size(mesh.mesh_dim_names.index(ax))


def _check_mesh_input(x: torch.Tensor, mesh, data_axes) -> None:
    """The three mismatches that raise before any collective runs."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the mesh executor needs an initialized default process group: "
            "call torch.distributed.init_process_group(...) on every rank")
    if x.device.type != mesh.device_type:
        raise ValueError(f"data on {x.device} but the mesh is over "
                         f"{mesh.device_type!r} devices")
    for ax in data_axes:
        if (dist.get_backend(mesh.get_group(ax)) == "nccl"
                and x.device.type != "cuda"):
            raise ValueError(f"the NCCL group of mesh axis {ax!r} takes "
                             f"CUDA tensors only, got {x.device}")


def _all_reduce(t: torch.Tensor, op: str, mesh,
                data_axes: tuple[str, ...]) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` under ``op`` ("sum", "min", "max")
    over each data axis in turn (one collective per axis, each counted by
    ``engine.collective_counter`` and each a ``mesh.allreduce`` span).
    Returns ``t``."""
    for ax in data_axes:
        with spans.span("mesh.allreduce"):
            engine_lib.record_collective(op, t.numel() * t.element_size())
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=mesh.get_group(ax))
    return t


def local_moments(x: torch.Tensor, y: torch.Tensor, degree: int, *,
                  basis: str = basis_lib.MONOMIAL,
                  weights: torch.Tensor | None = None,
                  accum_dtype=None,
                  engine: str = "auto",
                  use_kernel: bool | None = None,
                  domain: basis_lib.Domain | None = None
                  ) -> moments_lib.Moments:
    """One rank's moment accumulation over its own block.

    Routes through ``engine.plan_fit`` on the block's device (a CUDA
    block takes the kernels), which validates the basis on kernel paths:
    forcing the kernel with a non-monomial basis raises here.  With a
    ``domain``, x is raw and the moments are those of ``domain.apply(x)``
    (``engine.compute_moments``).  ``use_kernel`` is a deprecated alias of
    ``engine=``."""
    plan = engine_lib.plan_fit(
        tuple(x.shape), degree, basis=basis, dtype=x.dtype,
        weighted=weights is not None,
        engine=engine_lib.resolve_engine(engine, use_kernel),
        accum_dtype=accum_dtype, device=x.device)
    return engine_lib.compute_moments(plan, x, y, weights, domain=domain)


def psum_moments(m: moments_lib.Moments, mesh,
                 data_axes: tuple[str, ...] = ("data",)
                 ) -> moments_lib.Moments:
    """The one collective of the whole algorithm: every field of ``m`` in
    one flat buffer, one SUM all-reduce per data axis, O(m²) bytes."""
    fields = [getattr(m, f.name) for f in dataclasses.fields(m)]
    flat = torch.cat([f.reshape(-1) for f in fields])
    _all_reduce(flat, "sum", mesh, data_axes)
    out, at = [], 0
    for f in fields:
        out.append(flat[at:at + f.numel()].reshape(f.shape).to(f.dtype))
        at += f.numel()
    return moments_lib.Moments(*out)


def _global_domain(x: torch.Tensor, w: torch.Tensor | None, mesh,
                   data_axes) -> basis_lib.Domain:
    """Global [-1, 1] domain over all blocks (the block's min/max, then a
    MIN and a MAX all-reduce: the second tiny collective of a normalized
    distributed fit).  Zero-weight entries are excluded (``w=None``: every
    point counts); a degenerate zero range keeps the identity scale."""
    if w is None:
        lo, hi = (a.reshape(1) for a in torch.aminmax(x))
    else:
        big = torch.finfo(x.dtype).max
        live = w > 0
        lo = torch.amin(torch.where(live, x, big)).reshape(1)
        hi = torch.amax(torch.where(live, x, -big)).reshape(1)
    _all_reduce(lo, "min", mesh, data_axes)
    _all_reduce(hi, "max", mesh, data_axes)
    shift = (hi + lo) / 2.0
    half = (hi - lo) / 2.0
    one = torch.ones_like(half)
    scale = torch.where(half > 0, one / torch.where(half > 0, half, one),
                        one)
    return basis_lib.Domain(shift[0], scale[0])


# --------------------------------------------------------------------------
# the spec executor: every method × degree question, one mesh factory
# --------------------------------------------------------------------------
def make_spec_executor(spec, mesh, *,
                       data_axes: tuple[str, ...] = ("data",)):
    """Build the mesh program for a ``FitSpec``.

    Returns ``(runner, kind)``: every rank calls ``runner(x, y, weights=
    None)`` with its own block (the module's input contract) and gets
    replicated outputs whose shape ``kind`` names:

    * ``"fixed"``:  ``(poly, moments)``                (method="lse")
    * ``"iter"``:   ``(poly, moments, iters, conv)``   (irls / lspia)
    * ``"search"``: ``(poly, sweep, best_degree)``     (DegreeSearch)

    ``api.make_distributed`` wraps the tuple into a ``FitResult``; the
    legacy ``make_distributed_fit``/``_select`` shims return it raw.
    """
    from repro_torch import select as select_lib
    from repro_torch.api import spec as spec_lib
    from repro_torch.core import robust as robust_lib
    from repro_torch.select import crossval

    if spec.numerics.solver in spec_lib.RAW_DATA_SOLVERS:
        raise ValueError(
            f"solver={spec.numerics.solver!r} needs the raw Vandermonde "
            "rows and cannot run on the distributed moment surface; use "
            "the eager api.fit executor")
    devices_total = 1
    for ax in data_axes:
        devices_total *= _axis_size(mesh, ax)
    search = spec.is_search
    md = spec.max_degree
    folds = spec.folds if search else 0
    accum = spec.numerics.accum_dtype
    # eager validation + numerics resolution (a block's length is unknown
    # here, so plan with a placeholder: the path is re-planned per block
    # on its device inside local_moments; the numerics policy is resolved
    # here, once)
    plan = spec.plan((max(folds, 1), 1) if search else (1,),
                     accum or torch.float32, weighted=True,
                     workload="select" if search else "moments",
                     mesh=mesh, data_axes=data_axes)
    pol = plan.numerics
    normalized = pol.normalize or spec.domain is not None
    if search:
        ds = spec.degree
        criterion = ds.criterion
        if criterion is None:
            criterion = "cv" if folds >= 2 else "aicc"
        if criterion == "cv" and folds < 2:
            raise ValueError("criterion='cv' needs folds >= 2")
        ladder_solver = (spec.numerics.solver
                         if spec.numerics.solver != "auto" else ds.solver)
        ladder_fb, ladder_cap = ds.fallback, ds.cond_cap

    def apply_decay(x, w):
        """spec.decay as the GLOBAL age ladder: each rank reconstructs its
        points' global positions from its mesh coordinates (blocks are
        laid out row-major over the data axes), so the γ-weighting is the
        eager surface's ``decay_ladder`` over the whole series; the ages
        are computed in x's dtype, as the reference does.  ``w=None``
        returns the ladder alone."""
        if spec.decay == 1.0:
            return w
        pos = 0
        for ax in data_axes:
            pos = pos * _axis_size(mesh, ax) + mesh.get_local_rank(ax)
        n_local = x.shape[-1]
        n_global = n_local * devices_total
        idx = pos * n_local + torch.arange(n_local, device=x.device)
        age = (n_global - 1) - idx.to(x.dtype)
        gamma = torch.tensor(spec.decay, dtype=x.dtype, device=x.device)
        ladder = gamma ** age
        return ladder if w is None else w * ladder

    def gmoments(xt, y, w, domain=None):
        """One global accumulation: the block's moments + the all-reduce
        (with ``domain``, xt is raw and mapped by the moment pass)."""
        return psum_moments(
            local_moments(xt, y, md, basis=spec.basis, weights=w,
                          accum_dtype=accum, engine=spec.engine,
                          domain=domain),
            mesh, data_axes)

    def solve(m):
        ms = m.regularized(spec.ridge) if spec.ridge else m
        return solve_lib.solve_with_fallback(
            ms.gram, ms.vty, method=pol.solver, fallback=pol.fallback,
            cond_cap=pol.cond_cap)

    def mk_poly(coeffs, dom, diag):
        return fit_lib.Polynomial(coeffs=coeffs, domain_shift=dom.shift,
                                  domain_scale=dom.scale, basis=spec.basis,
                                  diagnostics=diag)

    def irls_weights_loop(xt, y, w):
        """The IRLS loop, mesh-wide: every sweep is one O(m²) moment
        all-reduce and one scale all-reduce; the stop test reads the
        replicated coefficients, so every rank takes the same number of
        trips.  The robust scale is the contributing-block mean of the
        block MADs (an exact global median would need its own iterative
        collective; on shuffled blocks the block MADs agree to
        O(1/√n_block)).  ``w=None`` takes the unweighted moment pass for
        the first solve; the sweeps are weighted by ψ anyway."""
        opts = spec.irls
        cval = robust_lib.resolve_tuning(opts.loss, opts.c)
        tol = max(float(opts.tol), 500.0 * float(torch.finfo(xt.dtype).eps))

        def sigma_of(coeffs):
            r = y - basis_lib.evaluate(coeffs, xt, basis=spec.basis)
            sig = robust_lib.chunk_scale(r, w, y)[..., 0]
            has = torch.any(w > 0).to(xt.dtype)
            buf = torch.cat([(sig * has).reshape(-1), has.reshape(1)])
            _all_reduce(buf, "sum", mesh, data_axes)
            num = buf[:-1].reshape(sig.shape)
            den = torch.clamp(buf[-1], min=1.0)
            return r, (num / den)[..., None]

        def reweight(coeffs):
            r, sigma = sigma_of(coeffs)
            return robust_lib.robust_weights(r / sigma, opts.loss, cval) * w

        m = gmoments(xt, y, w)
        coeffs, cond, used = solve(m)
        if w is None:
            w = torch.ones_like(xt)
        delta = torch.full(tuple(xt.shape[:-1]), float("inf"),
                           dtype=xt.dtype, device=xt.device)
        it = 0
        while it < opts.max_iter and robust_lib.still_moving(delta, tol):
            m = gmoments(xt, y, reweight(coeffs))
            new, cond, used = solve(m)
            scale = torch.clamp(torch.amax(torch.abs(new), dim=-1), min=1.0)
            delta = torch.amax(torch.abs(new - coeffs), dim=-1) / scale
            coeffs = new
            it += 1
        return coeffs, cond, used, m, reweight(coeffs), delta <= tol, it

    # ------------------------------------------------------------ programs
    def prepare(x, w):
        """The decayed weights and the domain (global under normalize)."""
        w = apply_decay(x, w)
        with spans.span("fit.domain"):
            return w, basis_lib.Domain.choose(
                x, normalize=pol.normalize,
                pinned=spec.domain_or(dtype=x.dtype, device=x.device),
                from_data=lambda x: _global_domain(x, w, mesh, data_axes))

    if search:
        def _run(x, y, w):
            w, dom = prepare(x, w)
            with spans.span("fit.domain"):
                xt = dom.apply(x)
            if spec.method == "irls":
                # robust weights established mesh-wide at max_degree, then
                # the usual single-pass weighted ladder on top of them
                w_eff = irls_weights_loop(xt, y, w)[4]
            else:
                w_eff = w
            if folds >= 2:
                fm = crossval.fold_moments(xt, y, folds, md, weights=w_eff,
                                           basis=spec.basis,
                                           engine=spec.engine,
                                           accum_dtype=accum)
                fm = psum_moments(fm, mesh, data_axes)  # folds global
                total = crossval.sum_folds(fm)
            else:
                fm = None
                total = gmoments(xt, y, w_eff)
            mr = total.regularized(spec.ridge) if spec.ridge else total
            sweep = select_lib.sweep_from_moments(
                mr, fold_moments=fm,
                score_moments=total if spec.ridge else None,
                solver=ladder_solver, fallback=ladder_fb,
                cond_cap=ladder_cap, basis=spec.basis, normalized=normalized)
            best = sweep.best(criterion)
            # the winning fit in the padded ladder layout, WITH its Domain,
            # so raw-x evaluation is right
            diag = fit_lib.FitDiagnostics(
                condition=sweep.condition[..., best],
                fallback_used=sweep.fallback_used[..., best],
                solver=ladder_solver, fallback=ladder_fb or "none")
            return mk_poly(sweep.coeffs[..., best, :], dom, diag), sweep, best

    elif spec.method == "irls":
        def _run(x, y, w):
            w, dom = prepare(x, w)
            with spans.span("fit.domain"):
                xt = dom.apply(x)
            coeffs, cond, used, m, _, conv, it = irls_weights_loop(xt, y, w)
            diag = fit_lib.FitDiagnostics(
                condition=cond, fallback_used=used, solver=pol.solver,
                fallback=pol.fallback or "none")
            return mk_poly(coeffs, dom, diag), m, it, conv

    elif spec.method == "lspia":
        def _run(x, y, w):
            # the mesh already pays the O(m²) all-reduce, so the fixed
            # point is reached by Richardson on the all-reduced normal
            # equations (moment-space LSPIA): matrix-free sweeps would
            # cost one collective per iteration instead of one in all
            w, dom = prepare(x, w)
            with spans.span("fit.domain"):
                xt = dom.apply(x)
            m = gmoments(xt, y, w)
            ms = m.regularized(spec.ridge) if spec.ridge else m
            opts = spec.lspia
            coeffs, cond, conv, it = lspia_lib.lspia_solve_moments(
                ms.gram, ms.vty, tol=opts.tol, max_iter=opts.max_iter,
                power_iters=opts.power_iters, step=opts.step,
                momentum=opts.momentum)
            diag = fit_lib.FitDiagnostics(condition=cond,
                                          fallback_used=~conv,
                                          solver="lspia", fallback="none")
            return mk_poly(coeffs, dom, diag), m, it, conv

    else:
        # plain matricized LSE: the paper's algorithm, mesh-wide; the
        # mapped x would feed the moments alone, so the kernel maps it
        def _run(x, y, w):
            w, dom = prepare(x, w)
            m = gmoments(x, y, w, dom)
            ms = m.regularized(spec.ridge) if spec.ridge else m
            poly = fit_lib.fit_from_moments(ms, solver=pol.solver,
                                            fallback=pol.fallback,
                                            cond_cap=pol.cond_cap,
                                            domain=dom, basis=spec.basis,
                                            normalized=normalized)
            return poly, m

    def runner(x: torch.Tensor, y: torch.Tensor,
               weights: torch.Tensor | None = None):
        _check_mesh_input(x, mesh, data_axes)
        return _run(x, y, weights)

    kind = ("search" if search
            else "iter" if spec.method in ("irls", "lspia") else "fixed")
    return runner, kind


# --------------------------------------------------------------------------
# legacy-signature shims: build a FitSpec, run the spec executor
# --------------------------------------------------------------------------
def make_distributed_fit(mesh, degree: int, *,
                         data_axes: tuple[str, ...] = ("data",),
                         method: str | None = None,
                         solver: str = "auto",
                         fallback: str | None = "svd",
                         basis: str = basis_lib.MONOMIAL,
                         normalize: bool = False,
                         accum_dtype=torch.float32,
                         engine: str = "auto",
                         use_kernel: bool | None = None):
    """A distributed fit: ``(x, y, weights) -> (Polynomial, Moments)``.
    Thin shim over ``make_spec_executor``: the kwargs assemble a
    ``FitSpec(method="lse")``.

    Each rank passes its block of x, y and weights (the module's input
    contract); weights mask padding (ragged global series).  The
    Polynomial comes out replicated.  ``normalize=True`` computes the
    global min/max first (the second tiny collective) and fits in the
    normalized domain.  ``use_kernel`` is a deprecated alias of
    ``engine=``; ``method=`` the legacy spelling of ``solver=``."""
    from repro_torch.api import spec as spec_lib
    from repro_torch.engine import plan as plan_lib
    engine = engine_lib.resolve_engine(engine, use_kernel)
    if method is not None:
        solver = method
    spec = spec_lib.FitSpec(
        degree=int(degree), basis=basis, method="lse",
        numerics=plan_lib.NumericsPolicy(accum_dtype=accum_dtype,
                                         normalize=normalize, solver=solver,
                                         fallback=fallback),
        engine=engine)
    runner, _ = make_spec_executor(spec, mesh, data_axes=data_axes)
    return runner


def make_distributed_select(mesh, max_degree: int, *,
                            folds: int = 5,
                            data_axes: tuple[str, ...] = ("data",),
                            criterion: str | None = None,
                            solver: str = "auto",
                            fallback: str | None = "svd",
                            cond_cap: float | None = None,
                            basis: str = basis_lib.MONOMIAL,
                            normalize: bool = False,
                            accum_dtype=torch.float32,
                            engine: str = "auto"):
    """Mesh-parallel single-pass degree selection: ``(x, y, weights) ->
    (poly, sweep, best_degree)``, all replicated.  Thin shim over
    ``make_spec_executor``: the kwargs assemble a
    ``FitSpec(degree=DegreeSearch(...))``.

    Each rank accumulates its block's k-fold moment partials (round-robin
    within the block: fold membership is an arbitrary partition, so a
    local assignment is a valid global one) and ONE all-reduce of the
    (k, m+1, m+1) fold stack makes the folds global: selection's
    collective cost is O(k·m²) values, independent of n.  The ladder solve
    and scoring then run replicated on every rank.  ``folds < 2`` drops CV
    (one plain all-reduced state; AICc/BIC/GCV still select).

    ``poly`` is the winning fit in the zero-padded (max_degree+1) layout
    and carries its Domain, so evaluating it on raw x is right even when
    normalization mapped the fit to [-1, 1]; ``sweep.coeffs`` live in that
    same fitted domain and basis."""
    from repro_torch import select as select_lib
    from repro_torch.api import spec as spec_lib
    from repro_torch.engine import plan as plan_lib
    spec = spec_lib.FitSpec(
        degree=select_lib.DegreeSearch(max_degree=int(max_degree),
                                       folds=int(folds),
                                       criterion=criterion, solver=solver,
                                       fallback=fallback,
                                       cond_cap=cond_cap),
        basis=basis, method="lse",
        numerics=plan_lib.NumericsPolicy(accum_dtype=accum_dtype,
                                         normalize=normalize,
                                         solver="auto", fallback=fallback,
                                         cond_cap=cond_cap),
        engine=engine)
    runner, _ = make_spec_executor(spec, mesh, data_axes=data_axes)
    return runner


def distributed_fit_input_specs(n_global: int, dtype=torch.float32):
    """Shape-and-dtype stand-ins (``meta`` tensors) for a dry run of the
    fit itself."""
    s = torch.empty((n_global,), dtype=dtype, device="meta")
    return dict(x=s, y=s, weights=s)


# --------------------------------------------------------------------------
# asynchronous LSPIA: barrier-free shard contributions (arXiv:2211.06556)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ShardSweep:
    """Coordinator → shard: "compute your normal-equation gradient against
    these version-``version`` coefficients".  ``seq`` is the per-shard
    sequence number (idempotent delivery: the coordinator accepts exactly
    one reply per outstanding seq).  ``kind="ingest"`` so the chaos
    injector's drop fault hits sweeps exactly as it hits fleet ingests."""

    shard: int
    seq: int
    version: int
    coeffs: np.ndarray
    kind: str = "ingest"


@dataclasses.dataclass
class ShardDelta:
    """Shard → coordinator: gᵢ = VᵢᵀWᵢ(yᵢ − Vᵢ c_version), stamped with
    the coefficient version it was computed against.  ``kind="result"``
    so the chaos poison fault can corrupt it (and the coordinator's
    finite-validation must catch that)."""

    shard: int
    seq: int
    version: int
    delta: np.ndarray
    worker: int = 0
    kind: str = "result"

    def poisoned(self) -> "ShardDelta":
        return dataclasses.replace(
            self, delta=np.full_like(self.delta, np.nan))


def _shard_gradient(xt, y, w, c, degree: int, basis: str) -> torch.Tensor:
    """Vᵀ W (y − V c) on one shard, matrix-free."""
    f = basis_lib.evaluate(c, xt, basis=basis)
    return lspia_lib.vt_apply(xt, w * (y - f), degree, basis=basis)


class AsyncLSPIAShard:
    """One data shard speaking the fleet mailbox protocol (``process(msg,
    tick) -> [reply]`` / ``reset()``), so ``runtime.chaos.ChaosWorker``
    wraps it unchanged.  Stateless between sweeps — the shard's partition
    IS its identity — so a chaos crash + revive loses nothing but the
    in-flight sweep (which the coordinator's retry resends)."""

    def __init__(self, shard_id: int, xt, y, w, degree: int, basis: str):
        self.shard_id = shard_id
        self._xt, self._y, self._w = xt, y, w
        self._degree, self._basis = degree, basis
        self.sweeps_done = 0

    def reset(self) -> None:
        self.sweeps_done = 0

    def process(self, msg, tick: int) -> list:
        if getattr(msg, "kind", None) != "ingest":
            return []
        c = torch.from_numpy(np.asarray(msg.coeffs)).to(
            dtype=self._xt.dtype, device=self._xt.device)
        g = _shard_gradient(self._xt, self._y, self._w, c,
                            self._degree, self._basis)
        self.sweeps_done += 1
        return [ShardDelta(shard=self.shard_id, seq=msg.seq,
                           version=msg.version, delta=g.cpu().numpy(),
                           worker=self.shard_id)]


@dataclasses.dataclass
class AsyncLSPIAFit:
    """An asynchronous LSPIA fit: polynomial + the coordinator's record.

    ``iterations`` counts coefficient versions applied (the async analogue
    of sweeps); ``stats`` surfaces every fault-path event — stale
    rejections, poisoned deltas, resends, straggler verdicts and the
    ``runtime.straggler`` reslice plan they imply, and crucially
    ``updates_during_stall``: coordinator updates applied while at least
    one shard was chaos-stalled (the no-global-barrier property, > 0 in
    any stalled run that converged)."""

    poly: fit_lib.Polynomial
    iterations: int
    ticks: int
    converged: bool
    grad_norm: float
    step: float
    stats: dict
    metrics: object | None = None   # the run's obs.MetricsRegistry


def async_lspia_fit(x, y, spec, *, n_shards: int = 4,
                    weights=None, chaos=None,
                    work_per_tick: int = 1,
                    max_ticks: int = 200_000,
                    retry_ticks: int = 8,
                    restart_ticks: int = 8,
                    straggler_every: int = 4,
                    straggler_threshold: float = 3.0,
                    registry=None, device=None) -> AsyncLSPIAFit:
    """Barrier-free distributed LSPIA on the virtual-tick mailbox substrate,
    with the shards on ``device`` (``None`` means CUDA).

    ``spec`` must be ``FitSpec(method="lspia")``; its ``LSPIAOptions``
    supply tol / max-iteration budget / ``momentum`` (heavy-ball on the
    coordinator's updates) and ``staleness`` — the bounded-delay window of
    the asynchronous convergence result: a delta computed more than
    ``staleness`` coefficient versions ago is rejected (and excluded from
    the accumulated gradient until its shard refreshes), and convergence
    is only declared when the combined gradient is small AND every shard's
    contribution is within the window.  The coordinator's step is the
    synchronous safe step damped by the staleness bound
    (μ = μ_sync / (1 + s/2), the classic delayed-gradient stability
    margin), with the same divergence freeze guard as the eager path.

    ``chaos`` takes a ``runtime.chaos.ChaosSchedule``; every fault kind
    applies (sweeps are droppable "ingest"s, deltas poisonable "result"s,
    shards stall/crash/delay like fleet workers).  Straggler verdicts come
    from ``runtime.fault_tolerance.FailureDetector`` — the paper's own LSE
    fitting per-shard reply gaps — and each verdict is answered with a
    ``runtime.straggler.plan_reslice`` share plan in ``stats["reslice"]``.

    Requires ``spec.decay == 1.0``: asynchronous delivery has no global
    age order, so exponential forgetting is not defined on this surface.
    """
    if spec.method != "lspia":
        raise ValueError(f"async_lspia_fit needs method='lspia', got "
                         f"{spec.method!r}")
    if spec.is_search:
        raise ValueError("async_lspia_fit serves fixed degrees; run "
                         "DegreeSearch on the moment surfaces")
    if spec.decay != 1.0:
        raise ValueError(
            "async delivery has no global age order: decay must be 1.0 "
            f"(got {spec.decay})")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    if x.ndim != 1 or x.shape != y.shape:
        raise ValueError(f"expected equal 1-D x/y, got {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.shape[0] < n_shards:
        raise ValueError(f"{x.shape[0]} points cannot fill {n_shards} "
                         "shards")
    degree = int(spec.degree)
    basis = spec.basis
    opts = spec.lspia
    staleness = int(opts.staleness)
    beta = float(opts.momentum)
    ridge = float(spec.ridge)
    w = (torch.ones_like(x) if weights is None
         else as_tensor(weights, dev, x.dtype))
    plan = spec.plan(tuple(x.shape), x.dtype, weighted=weights is not None,
                     workload="lspia", device=dev)
    dom = basis_lib.Domain.choose(
        x, normalize=plan.numerics.normalize,
        pinned=spec.domain_or(dtype=x.dtype, device=dev))
    xt = dom.apply(x)

    # safe synchronous step (same settledness-gated trace clamp as the
    # eager path), then the bounded-delay damping
    tiny = float(torch.finfo(x.dtype).tiny)
    lam, lam_prev = lspia_lib._lambda_max(xt, w, degree, basis,
                                          opts.power_iters, with_prev=True)
    lam = float(lam) + ridge
    tr_ub = float(lspia_lib._trace_normal(xt, w, degree, basis)) \
        + ridge * (degree + 1)
    settled = abs(lam - (float(lam_prev) + ridge)) <= 0.05 * lam
    lam_safe = lam if settled else max(lam, tr_ub)
    mu_sync = (1.0 / max(lam_safe, tiny) if opts.step is None
               else float(opts.step))
    mu = mu_sync / (1.0 + 0.5 * staleness)

    bvec = lspia_lib.vt_apply(xt, w * y, degree, basis=basis).cpu().numpy()
    # reprolint: disable=RL-DTYPE — f64 LSPIA iterate
    bvec = bvec.astype(np.float64)
    gref = max(float(np.linalg.norm(bvec)), tiny)
    tol = max(float(opts.tol), 25.0 * float(torch.finfo(x.dtype).eps))
    cap = lspia_lib._DIVERGE_FACTOR * gref

    bounds = np.linspace(0, x.shape[0], n_shards + 1).astype(int)
    schedule = chaos or chaos_lib.ChaosSchedule()
    workers = [
        chaos_lib.ChaosWorker(
            AsyncLSPIAShard(i, xt[bounds[i]:bounds[i + 1]],
                            y[bounds[i]:bounds[i + 1]],
                            w[bounds[i]:bounds[i + 1]], degree, basis),
            i, schedule.for_worker(i))
        for i in range(n_shards)]
    detector = FailureDetector(n_shards, timeout_s=float(max_ticks),
                               straggler_threshold=straggler_threshold,
                               device=dev)

    m1 = degree + 1
    c = np.zeros(m1, np.float64)  # reprolint: disable=RL-DTYPE — f64 iterate
    c_prev = c.copy()
    version = 0
    latest: list[np.ndarray | None] = [None] * n_shards
    latest_version = [-1] * n_shards
    next_seq = [0] * n_shards
    # outstanding[i] = (seq, sent_tick) of the sweep awaiting a reply
    outstanding: list[tuple[int, int] | None] = [None] * n_shards
    inbox: list[list] = [[] for _ in range(n_shards)]
    due: list[tuple[int, int, ShardDelta]] = []
    due_n = 0
    last_reply = [0] * n_shards
    died_at: dict[int, int] = {}
    gnorm = gref
    gprev = float("inf")
    # counters live in an obs registry (caller-supplied to share one
    # scrape surface, else private); the returned ``stats`` dict is a
    # view over it plus the non-counter records below
    reg = registry if registry is not None else obs_metrics.MetricsRegistry()
    ctr = {k: reg.counter(k) for k in
           ("updates", "updates_during_stall", "stale_rejected",
            "poisoned", "resends", "duplicates", "crashes", "freezes")}
    lag_gauge = reg.gauge("staleness_lag")   # hwm = worst in-window lag
    straggler_verdicts: list = []
    reslice = None
    converged = False
    tick = 0

    def send_sweep(i: int) -> None:
        if len(inbox[i]) >= 4:      # bounded mailbox: a stalled shard's
            return                  # queue must not grow without limit
        next_seq[i] += 1
        outstanding[i] = (next_seq[i], tick)
        inbox[i].append(ShardSweep(shard=i, seq=next_seq[i],
                                   version=version, coeffs=c.copy()))

    while tick < max_ticks and not converged:
        tick += 1
        for i, wk in enumerate(workers):
            wk.begin_tick(tick)
            if not wk.alive and i not in died_at:
                died_at[i] = tick
                ctr["crashes"].inc()
            if not wk.alive and tick - died_at.get(i, tick) >= \
                    restart_ticks:
                wk.revive()
                inbox[i].clear()
                outstanding[i] = None
                del died_at[i]
        stalled_now = any(wk.stalled(tick) for wk in workers)
        # pump shard mailboxes (a stalled shard heartbeats but computes
        # nothing — its inbox just waits)
        for i, wk in enumerate(workers):
            if not wk.alive or wk.stalled(tick):
                continue
            for _ in range(work_per_tick):
                if not inbox[i]:
                    break
                msg = inbox[i].pop(0)
                for delay, rep in wk.process(msg, tick):
                    due.append((tick + delay, due_n, rep))
                    due_n += 1
        # deliver due replies
        due.sort()
        fresh = False
        while due and due[0][0] <= tick:
            _, _, rep = due.pop(0)
            i = rep.shard
            out = outstanding[i]
            if out is None or rep.seq != out[0]:
                ctr["duplicates"].inc()
                continue
            outstanding[i] = None
            last_reply[i] = tick
            if not np.all(np.isfinite(rep.delta)):
                ctr["poisoned"].inc()       # chaos poison: recompute
                continue
            if version - rep.version > staleness:
                ctr["stale_rejected"].inc()     # outside the bounded-
                continue                        # delay window: recompute
            # reprolint: disable=RL-DTYPE — deltas join the f64 iterate
            latest[i] = rep.delta.astype(np.float64)
            latest_version[i] = rep.version
            fresh = True
        # staleness-bounded accumulation: only in-window contributions
        # enter the combined gradient (a stalled shard's ancient delta
        # must not keep steering the iterate)
        in_window = [i for i in range(n_shards)
                     if latest[i] is not None
                     and version - latest_version[i] <= staleness]
        # worst version lag among contributing shards (hwm = worst seen):
        # the live "how stale is the slowest voice in the gradient" gauge
        if in_window:
            lag_gauge.set(max(version - latest_version[i]
                              for i in in_window))
        if fresh and in_window:
            gsum = sum(latest[i] for i in in_window) - ridge * c
            gn = float(np.linalg.norm(gsum))
            if not np.isfinite(gn) or gn > cap:
                ctr["freezes"].inc()    # divergence freeze, as eager
            else:
                upd = c + mu * gsum + beta * (c - c_prev)
                c_prev, c = c, upd
                version += 1
                gprev, gnorm = gnorm, gn
                ctr["updates"].inc()
                if stalled_now:
                    ctr["updates_during_stall"].inc()
        # convergence: small combined gradient AND every shard current
        if (len(in_window) == n_shards and gnorm <= tol * gref
                and ctr["updates"].value > 0):
            converged = True
            break
        # refill / retry sweeps
        for i in range(n_shards):
            out = outstanding[i]
            if out is None:
                send_sweep(i)
            elif tick - out[1] > retry_ticks:
                ctr["resends"].inc()    # dropped/lost sweep: resend with
                send_sweep(i)           # a fresh seq (old reply ignored)
        # straggler verdicts from the paper's own LSE on reply gaps
        if tick % straggler_every == 0:
            gaps = [float(max(1, tick - last_reply[i]))
                    for i in range(n_shards)]
            detector.observe_step(tick // straggler_every, gaps,
                                  now=float(tick))
            v = detector.verdict(tick // straggler_every, now=float(tick))
            if v["stragglers"]:
                straggler_verdicts.append(
                    (tick, tuple(v["stragglers"])))
                try:
                    reslice = straggler_lib.plan_reslice(
                        detector.steptime, tick // straggler_every,
                        int(x.shape[0]), min_share=1).shares
                except ValueError:
                    pass

    if ctr["updates"].value >= 2 and gprev > 0 and np.isfinite(gprev):
        rho = gnorm / gprev
    else:
        rho = 0.0
    lam_mu = lam_safe * mu
    cond = (float("inf") if rho >= 1.0
            else max(lam_mu / (1.0 - rho), 1.0))
    stats = {"n_shards": n_shards, "staleness": staleness,
             **{k: c.value for k, c in ctr.items()},
             "straggler_verdicts": straggler_verdicts, "reslice": reslice,
             "sweeps_per_shard": [wk.inner.sweeps_done for wk in workers]}
    dtype = x.dtype
    diag = fit_lib.FitDiagnostics(
        condition=torch.tensor(cond, dtype=dtype, device=dev),
        fallback_used=torch.tensor(not converged, device=dev),
        solver="lspia", fallback="none")
    poly = fit_lib.Polynomial(coeffs=torch.from_numpy(c).to(dtype=dtype,
                                                             device=dev),
                              domain_shift=dom.shift,
                              domain_scale=dom.scale, basis=basis,
                              diagnostics=diag)
    return AsyncLSPIAFit(poly=poly, iterations=version, ticks=tick,
                         converged=converged, grad_norm=gnorm, step=mu,
                         stats=stats, metrics=reg)
