"""Continuous-batching fit server: the paper's workload as a service (port
of ``repro.serve.fit_engine``).

Ragged per-request (x, y) series arrive, are bucketed by length onto
fixed-width slot pools, and ingest through the matricized moment
accumulator with per-slot streaming ``StreamState`` (on the card: the
packed CUDA moment kernel, via ``engine.plan_fit``), so a million-point
series occupies one slot and folds in chunk by chunk while short requests
churn through the other slots.

Static shapes: every bucket owns one fused ingest+solve step of shape
(n_slots, width).  On a step where a request completes, the chunk
accumulates into the slots' moments AND the pool's default fixed spec is
solved in the same step; mid-series steps (only the widest bucket takes
them) run a plain ingest.  Padding rides in with weight 0, slot reuse
zeroes the slot's moments with a keep-mask inside the step, and per-slot
IRLS is selected by runtime mask/loss/c arrays, so arrival, departure,
solver policy and loss mix never change a shape.

Requests carry their own ``FitSpec`` (``submit(x, y, spec=...)``): the
solve side (solver/fallback/cond_cap, ridge, LSE or moment-space LSPIA, a
fixed degree ≤ the pool's, or a DegreeSearch over the nested ladder) is
honoured per request.  The accumulation side (basis, engine, decay, pinned
domain, max degree) is pool-wide and comes from ``FitServeConfig``.

``compiled_executables()`` keeps the reference's meaning without a
compiler: each step function remembers the keys it has run under (the
static spec plus the shapes and dtypes of its arguments: the key the
reference's ``jax.jit`` cache uses) and the engine counts them.  After
``warmup()`` the count is constant, plus one per novel request spec.

The host loop is synchronous and deterministic.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch import select as select_lib
from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import lspia as lspia_lib
from repro_torch.core import moments as moments_lib
from repro_torch.core import robust as robust_lib
from repro_torch.core import solve as solve_lib
from repro_torch.core import streaming
from repro_torch.device import resolve_device


def _signature(a):
    """The cache key of one argument: shapes and dtypes of tensors and
    arrays, field by field through dataclasses and sequences, and the
    value itself for anything else (a spec, a scalar)."""
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype)
    if isinstance(a, np.ndarray):
        return ("array", a.shape, a.dtype.str)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (type(a).__name__,) + tuple(
            _signature(getattr(a, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return tuple(_signature(v) for v in a)
    return a


# called as observer(step name, key) on each key a StepFunction has not run
# under before (``repro_torch.analysis.CompileCounter`` appends here); the
# fleet's steps are this module's, so this one list sees both servers
KEY_OBSERVERS: list = []


class StepFunction:
    """A serving step and the argument signatures it has run under: the
    count of distinct signatures is what the reference's jit cache size
    counts for the same traffic.  The fleet calls one from several worker
    threads, so a new key is recorded (and observed) once."""

    def __init__(self, fn):
        self.fn = fn
        self.name = getattr(fn, "__name__", type(fn).__name__)
        self._keys: set = set()
        self._lock = threading.Lock()

    def __call__(self, *args):
        key = _signature(args)
        with self._lock:
            new = key not in self._keys
            self._keys.add(key)
        if new:
            for observe in list(KEY_OBSERVERS):
                observe(self.name, key)
        return self.fn(*args)

    def _cache_size(self) -> int:
        return len(self._keys)


@dataclasses.dataclass
class FitRequest:
    """One fit job: a ragged series in, a polynomial + quality report out.

    ``spec`` is the request's ``FitSpec``.  DegreeSearch specs
    (``auto=True``) come back with the chosen degree, ``scores`` (each
    criterion's per-degree row) and ``condition_ladder`` (κ per
    candidate degree)."""

    uid: int
    x: np.ndarray                      # (n,) host-side series
    y: np.ndarray
    spec: Any = None                   # the request's FitSpec
    auto: bool = False                 # automatic degree selection requested
    coeffs: np.ndarray | None = None   # (degree+1,) when done
    sse: float | None = None
    r: float | None = None
    count: float | None = None         # points the fit actually used
    condition: float | None = None     # estimated κ(Gram) at solve time
    fallback_used: bool | None = None  # rescue solver produced the coeffs
    degree: int | None = None          # chosen degree (auto requests)
    scores: dict | None = None         # per-degree criterion rows (auto)
    condition_ladder: np.ndarray | None = None   # per-degree κ (auto)
    done: bool = False

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass(frozen=True)
class FitServeConfig:
    degree: int = 3                     # pool accumulation degree AND the
    # ceiling for per-request degrees / DegreeSearch ladders
    n_slots: int = 8                    # concurrent series per bucket
    buckets: tuple[int, ...] = (256, 2048)   # chunk widths, ascending
    solver: str = "auto"                # condition-aware solve (core.solve)
    fallback: str | None = "svd"        # rank-revealing rescue (None = off)
    method: str | None = None           # legacy spelling of solver=
    ridge: float = 1e-9                 # λI stabilizer for the pooled solve
    # (idle slots hold all-zero moments and degenerate series are accepted,
    # so the pooled solve must never be exactly singular)
    decay: float = 1.0                  # exponential forgetting (γ=1: off);
    # γ<1 assumes full chunks (ages are counted inside each ingest chunk)
    engine: str = "auto"                # engine.plan_fit path selection
    select_criterion: str = "aicc"      # default auto-degree criterion
    # (moment-space only: the slot pool keeps no fold partials)
    dtype: Any = torch.float32
    spec: Any = None                    # a FitSpec supplying the pool-wide
    # accumulation policy AND the default per-request solve; overrides the
    # flat fields above


@dataclasses.dataclass(frozen=True)
class PoolSpecs:
    """The server-side spec family one ``FitServeConfig`` implies: what the
    slots accumulate (``pool``, fixed max degree), the default fixed and
    auto-degree request specs, and the spec a bare ``submit(x, y)``
    gets."""

    pool: Any
    fixed: Any
    auto: Any
    default: Any
    select_criterion: str


def validate_pool_spec(spec) -> None:
    # only an EXPLICIT normalize request is rejected: the server cannot
    # derive min/max of unseen series, so high-degree pools accumulate
    # raw-domain moments and lean on solve-time escalation (pin
    # FitSpec.domain to get true normalization)
    from repro_torch.api import spec as spec_lib
    if spec.numerics.solver in spec_lib.RAW_DATA_SOLVERS:
        raise ValueError(
            f"solver={spec.numerics.solver!r} needs the raw Vandermonde "
            "rows; the slot pools only hold moments")
    if spec.numerics.normalize and spec.domain is None:
        raise ValueError(
            "this spec normalizes the domain, but the server cannot "
            "derive min/max from series it has not seen — pin it with "
            "FitSpec(domain=(shift, scale))")


def derive_pool_specs(cfg: "FitServeConfig") -> PoolSpecs:
    """Map one ``FitServeConfig`` onto the ``PoolSpecs`` family."""
    from repro_torch.api import spec as spec_lib
    from repro_torch.engine import plan as plan_lib
    if cfg.select_criterion not in select_lib.MOMENT_CRITERIA:
        raise ValueError(
            f"select_criterion={cfg.select_criterion!r}; the slot pool "
            f"keeps no fold partials, so only moment-space criteria "
            f"{select_lib.MOMENT_CRITERIA} can serve auto-degree "
            "requests")
    if cfg.spec is not None:
        base = cfg.spec
    else:
        solver = cfg.method or cfg.solver
        base = spec_lib.FitSpec(
            degree=cfg.degree,
            numerics=plan_lib.NumericsPolicy(solver=solver,
                                             fallback=cfg.fallback),
            decay=cfg.decay, ridge=cfg.ridge, engine=cfg.engine)
    # the pool-wide spec: what the slots accumulate (fixed max degree)
    pool = (dataclasses.replace(base, degree=base.max_degree)
            if base.is_search else base)
    validate_pool_spec(pool)
    ds = (base.degree if base.is_search
          else select_lib.DegreeSearch(
              max_degree=pool.max_degree, folds=0,
              criterion=cfg.select_criterion,
              solver=pool.numerics.solver,
              fallback=pool.numerics.fallback,
              cond_cap=pool.numerics.cond_cap))
    # a DegreeSearch rides the condition-aware ladder solve, so an LSPIA
    # pool's auto requests search as LSE (the moments are method-free)
    auto = dataclasses.replace(
        base, degree=ds,
        method="lse" if base.method == "lspia" else base.method)
    default = base if base.is_search else pool
    return PoolSpecs(pool=pool, fixed=pool, auto=auto, default=default,
                     select_criterion=cfg.select_criterion)


def validate_request_spec(specs: PoolSpecs, spec) -> None:
    """Reject request specs the pool's accumulated state cannot serve."""
    from repro_torch.api import spec as spec_lib
    pool = specs.pool
    if spec.numerics.solver in spec_lib.RAW_DATA_SOLVERS:
        raise ValueError(
            f"solver={spec.numerics.solver!r} needs the raw Vandermonde "
            "rows; the slot pools only hold moments")
    if spec.basis != pool.basis:
        raise ValueError(
            f"request basis={spec.basis!r} but the pool accumulates "
            f"{pool.basis!r} moments — basis is pool-wide "
            "(FitServeConfig.spec)")
    if spec.domain != pool.domain:
        raise ValueError(
            f"request domain={spec.domain!r} but the pool accumulates "
            f"in domain {pool.domain!r} — the domain map is baked into "
            "the slots' moments (FitServeConfig.spec)")
    if spec.decay != pool.decay:
        raise ValueError(
            f"request decay={spec.decay} but the pool decays at "
            f"{pool.decay} — forgetting is baked into the running "
            "state (FitServeConfig.spec)")
    if spec.max_degree > pool.max_degree:
        raise ValueError(
            f"request degree {spec.max_degree} exceeds the pool's "
            f"accumulation degree {pool.max_degree}; nested degrees "
            "<= cfg.degree are served from the truncated state")
    if (spec.method == "irls"
            and spec.irls.stream_sweeps != pool.irls.stream_sweeps):
        raise ValueError(
            f"request stream_sweeps={spec.irls.stream_sweeps} but the "
            f"pool's ingest runs {pool.irls.stream_sweeps} — the sweep "
            "count is pool-wide (FitServeConfig.spec); per-request "
            "loss/c ARE honored")
    if spec.is_search:
        crit = spec.degree.criterion or specs.select_criterion
        if crit not in select_lib.MOMENT_CRITERIA:
            raise ValueError(
                f"criterion={crit!r}: the slot pool keeps no fold "
                f"partials, so only {select_lib.MOMENT_CRITERIA} can "
                "serve auto-degree requests")


def resolve_request_spec(specs: PoolSpecs, degree, spec):
    """Map the (degree=, spec=) submit spellings onto one FitSpec."""
    if spec is not None:
        if degree is not None:
            raise ValueError("pass degree= or spec=, not both")
        validate_request_spec(specs, spec)
        return spec
    if degree is None:
        return specs.default
    if degree == "auto":
        return specs.auto
    if int(degree) != specs.pool.max_degree:
        raise ValueError(
            f"degree={degree!r}: slot pools accumulate at the static "
            f"cfg.degree={specs.pool.max_degree}; pass degree='auto' for "
            "selection over the ladder 0..cfg.degree, or a FitSpec "
            "(spec=) for any nested degree <= cfg.degree")
    return specs.fixed


def validate_series(x, y, rspec) -> tuple[np.ndarray, np.ndarray]:
    """Submit-time series validation."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if x.ndim != 1 or x.shape != y.shape or x.shape[0] == 0:
        raise ValueError(f"expected equal non-empty 1-D x/y, got "
                         f"{x.shape} vs {y.shape}")
    if not rspec.is_search and x.shape[0] < int(rspec.degree) + 1:
        raise ValueError(
            f"series of {x.shape[0]} points cannot determine a "
            f"degree-{int(rspec.degree)} fit (need >= "
            f"{int(rspec.degree) + 1}); degree='auto' accepts short "
            "series (underdetermined rungs score +inf)")
    return x, y


def _spec_solve_from_state(state, spec, pool_degree: int):
    """The ONE definition of a per-request fixed-degree solve over a
    pool-degree state: the request's nested degree is a truncate view of
    the state; its numerics policy and method (LSE or moment-space LSPIA)
    come from the spec.  Run standalone (``make_spec_solve``) and after
    the ingest (``_Bucket.ingest_solve``): the same ops in the same order,
    so the two agree bit for bit."""
    d = int(spec.degree)
    m = (state.moments.truncate(d) if d < pool_degree
         else state.moments)
    if spec.method == "lspia":
        coeffs, cond, conv, _ = lspia_lib.lspia_solve_spec(m, spec)
        fb = ~conv
    else:
        ms = m.regularized(spec.ridge) if spec.ridge else m
        rung = spec.numerics.solver
        if rung == "auto":
            rung = solve_lib.select_solver(
                d, state.moments.gram.dtype, basis=spec.basis,
                normalized=spec.domain is not None)
        coeffs, cond, fb = solve_lib.solve_with_fallback(
            ms.gram, ms.vty, method=rung,
            fallback=spec.numerics.fallback,
            cond_cap=spec.numerics.cond_cap)
    rep = fit_lib.report_from_moments(m, coeffs)
    return (coeffs, rep.sse, rep.r, state.moments.count, cond, fb)


def make_spec_solve(pool_degree: int) -> StepFunction:
    """The step every serving surface answers a NON-default fixed-degree
    request spec with, keyed on (state shapes, spec)."""
    def solve(state, spec):
        return _spec_solve_from_state(state, spec, pool_degree)
    return StepFunction(solve)


def make_spec_sweep(pool_degree: int) -> StepFunction:
    """The auto-degree ladder solve over a pool-degree state."""
    def sweep(state, spec):
        # the request's ladder 0..max_degree from the (truncated view of
        # the) running moments: the same ridge stabilizer (idle slots must
        # stay solvable at every rung) but scored on the RAW moments, plus
        # the per-degree R of the padded ladder for the response report
        ds = spec.degree
        m = (state.moments.truncate(ds.max_degree)
             if ds.max_degree < pool_degree else state.moments)
        ridge = spec.ridge
        mr = m.regularized(ridge) if ridge else m
        rung = (spec.numerics.solver
                if spec.numerics.solver != "auto" else ds.solver)
        sw = select_lib.sweep_from_moments(
            mr, score_moments=m if ridge else None, solver=rung,
            fallback=ds.fallback, cond_cap=ds.cond_cap,
            basis=spec.basis, normalized=spec.domain is not None)
        rep = fit_lib.report_from_moments(m, sw.coeffs)
        return sw, rep.r, state.moments.count
    return StepFunction(sweep)


def host(a) -> np.ndarray:
    """A step function's output on the host, as numpy."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fill_fixed_result(req: FitRequest, spec, solved, s=None) -> None:
    """Populate one request from a fixed-degree solve's (numpy) outputs;
    ``s`` indexes a batched (slot-pool) solve, ``None`` a scalar one."""
    pick = (lambda a: a) if s is None else (lambda a: a[s])
    coeffs, sse, r, count, cond, fb = solved
    d = int(spec.degree)
    req.coeffs = np.asarray(pick(coeffs))[:d + 1].copy()
    req.sse = float(pick(sse))
    req.r = float(pick(r))
    req.count = float(pick(count))
    req.condition = float(pick(cond))
    req.fallback_used = bool(pick(fb))
    req.degree = d
    req.done = True


def auto_outputs(sw, r_ladder, count) -> dict:
    """One ``make_spec_sweep`` output on the host, once per solve (the
    per-request fill then just indexes)."""
    scores = {name: host(sw.scores.by_name(name))
              for name in select_lib.MOMENT_CRITERIA + ("sse", "r2")}
    return {"scores": scores, "ladder": host(sw.coeffs),
            "cond": host(sw.condition),
            "fb": host(sw.fallback_used),
            "r": host(r_ladder), "count": host(count)}


def fill_auto_result(req: FitRequest, spec, outs: dict, criterion: str,
                     s=None) -> None:
    """Populate one auto-degree request from ``auto_outputs``."""
    pick = (lambda a: a) if s is None else (lambda a: a[s])
    scores = outs["scores"]
    d = int(np.argmin(pick(scores[criterion])))
    req.degree = d
    req.coeffs = np.asarray(pick(outs["ladder"]))[d, :d + 1].copy()
    req.sse = float(pick(scores["sse"])[d])
    req.r = float(pick(outs["r"])[d])
    req.count = float(pick(outs["count"]))
    req.condition = float(pick(outs["cond"])[d])
    req.fallback_used = bool(pick(outs["fb"])[d])
    req.scores = {k: np.asarray(pick(v)).copy() for k, v in scores.items()}
    req.condition_ladder = np.asarray(pick(outs["cond"])).copy()
    req.done = True


class _Bucket:
    """One length bucket: a slot pool + its fused ingest+default-solve
    step."""

    def __init__(self, width: int, n_slots: int, engine: "FitServeEngine"):
        cfg = engine.cfg
        pool = engine.spec
        dev = engine.device
        self.width = width
        self.state = streaming.StreamState.create(
            pool.max_degree, (n_slots,), decay=pool.decay, dtype=cfg.dtype,
            device=dev)
        self.slot_req: list[FitRequest | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)    # points ingested
        self.reset = np.zeros(n_slots, bool)           # zero slot next step
        self.queue: list[FitRequest] = []
        dom = pool.domain_or(None, dtype=cfg.dtype, device=dev)
        rsolver = engine._pool_solver
        ridge = max(pool.ridge, 1e-9)   # the reweight solve must tolerate
        # idle/young slots even when the request asked for ridge=0
        degree = pool.max_degree
        sweeps = pool.irls.stream_sweeps

        def ingest(state, x, y, w, keep, rmask, loss_id, cval):
            # x, y, w, keep, loss_id, cval are on the card; rmask stays on
            # the host, so choosing the robust branch reads no device value.
            # keep == 0 wipes a slot's previous occupant (count included)
            m = state.moments
            k = keep.to(m.gram.dtype)
            m = moments_lib.Moments(
                gram=m.gram * k[:, None, None], vty=m.vty * k[:, None],
                yty=m.yty * k, count=m.count * k, weight_sum=m.weight_sum * k)
            st = streaming.StreamState(m, state.decay,
                                       host_decay=state.host_decay)
            xt = dom.apply(x) if dom is not None else x

            def solve(mm):
                mr = mm.regularized(ridge)
                coeffs, _, _ = solve_lib.solve_with_fallback(
                    mr.gram, mr.vty, method=rsolver, fallback="svd")
                return coeffs

            def reweight(w):
                # per-slot single-pass IRLS, the loss and tuning of each
                # slot selected by the per-slot arrays: one step serves
                # any robust/plain mix
                robust = torch.from_numpy(rmask > 0).to(x.device)[:, None]

                def psi(u):
                    wr = robust_lib.robust_weights_by_id(
                        u, loss_id[:, None], cval[:, None])
                    return torch.where(robust, wr, torch.ones_like(wr))
                wr = streaming.streaming_irls_weights(
                    st, xt, y, w, solve=solve, psi=psi, sweeps=sweeps,
                    engine=pool.engine, basis=pool.basis)
                return wr * w

            if np.any(rmask > 0):
                w = reweight(w)
            return streaming.update(st, xt, y, weights=w, basis=pool.basis,
                                    engine=pool.engine)

        self.ingest = StepFunction(ingest)
        # the fused step: accumulate the chunk AND solve the pool's default
        # fixed spec; non-default specs go through FitServeEngine._solve on
        # the returned state
        fixed_spec = engine.fixed_spec

        def ingest_solve(state, x, y, w, keep, rmask, loss_id, cval):
            st = ingest(state, x, y, w, keep, rmask, loss_id, cval)
            return st, _spec_solve_from_state(st, fixed_spec, degree)

        self.ingest_solve = StepFunction(ingest_solve)


class FitServeEngine:
    """Host-side continuous batching around per-bucket moment-ingest steps
    on ``device`` (``None`` means CUDA)."""

    def __init__(self, cfg: FitServeConfig | None = None,
                 obs: "obs_lib.Observability | None" = None, *,
                 device=None):
        from repro_torch.api import spec as spec_lib
        self.cfg = cfg = cfg or FitServeConfig()
        self.device = resolve_device(device)
        # observability is injected and OFF by default: the null bundle
        # makes every record below an empty method call
        self.obs = obs or obs_lib.NULL_OBS
        self._m_submitted = self.obs.metrics.counter("submitted")
        self._m_completed = self.obs.metrics.counter("completed")
        self._g_queue = self.obs.metrics.gauge("queue_depth")
        self._h_points = self.obs.metrics.histogram("points_per_fit")
        self._h_latency = self.obs.metrics.histogram("fit_latency_steps")
        self._step_no = 0
        self._admit_step: dict[int, int] = {}
        if tuple(sorted(cfg.buckets)) != tuple(cfg.buckets):
            raise ValueError(f"buckets must ascend: {cfg.buckets}")
        specs = self.pool_specs = derive_pool_specs(cfg)
        self.spec = specs.pool
        # default per-request specs for the legacy degree= spellings
        self.fixed_spec = specs.fixed
        self.auto_spec = specs.auto
        self.default_spec = specs.default
        # the reweight solve's rung (pool degree/dtype/basis)
        self._pool_solver = (
            self.spec.numerics.solver if self.spec.numerics.solver
            not in ("auto",) + spec_lib.RAW_DATA_SOLVERS
            else solve_lib.select_solver(
                self.spec.max_degree, cfg.dtype, basis=self.spec.basis,
                normalized=self.spec.domain is not None))
        self.buckets = [_Bucket(w, cfg.n_slots, self) for w in cfg.buckets]
        self._uid = 0
        self.fits_done = 0
        self.points_ingested = 0
        self._solve = make_spec_solve(self.spec.max_degree)
        self._sweep = make_spec_sweep(self.spec.max_degree)

    # ------------------------------------------------------------- plumbing
    def _resolve_spec(self, degree, spec):
        """Map the (degree=, spec=) submit spellings onto one FitSpec."""
        return resolve_request_spec(self.pool_specs, degree, spec)

    def submit(self, x, y, *, degree: int | str | None = None,
               spec=None) -> FitRequest:
        """Queue one ragged series; routed to the smallest bucket that holds
        it in one chunk, else the largest (multi-chunk streaming ingest).

        ``spec=`` attaches a full ``FitSpec`` to the request (its method,
        solve policy, a nested fixed degree <= cfg.degree, or a
        DegreeSearch over the nested ladder); ``degree=`` is the legacy
        spelling: the pool degree, or "auto"."""
        rspec = self._resolve_spec(degree, spec)
        auto = rspec.is_search
        x, y = validate_series(x, y, rspec)
        req = FitRequest(self._uid, x, y, spec=rspec, auto=auto)
        self._uid += 1
        self._m_submitted.inc()
        self.obs.tracer.instant(req.uid, "submit", self._step_no,
                                n=req.n, auto=bool(auto))
        for b in self.buckets[:-1]:
            if req.n <= b.width:
                b.queue.append(req)
                return req
        self.buckets[-1].queue.append(req)
        return req

    def warmup(self) -> int:
        """Run every step function once before live traffic: one
        full-width fixed-degree request AND one auto-degree request per
        bucket, plus one 3-chunk request whose mid-series chunk runs the
        widest bucket's plain ingest, drained at once.  Returns
        ``compiled_executables()``, the baseline the serving invariant is
        held against.  Deterministic: independent of live traffic."""
        if self.pending:
            raise RuntimeError("warmup() requires an idle engine")
        for b in self.buckets:
            n = max(b.width, self.spec.max_degree + 1)
            x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
            self.submit(x, x, spec=self.fixed_spec)
            self.submit(x, x, spec=self.auto_spec)
        # only the LAST bucket ever ingests multi-chunk series, so one
        # over-length request warms its mid-series step: 3 chunks long, so
        # at least one step is mid-series only
        n2 = 3 * self.buckets[-1].width
        x2 = np.linspace(-1.0, 1.0, n2, dtype=np.float32)
        self.submit(x2, x2, spec=self.fixed_spec)
        self.run()
        return self.compiled_executables()

    def compiled_executables(self) -> int:
        """Distinct (step, argument signature) pairs run so far: constant
        after warmup, plus one per NOVEL request spec, is the serving
        invariant.  The fused ingest+solve is one per bucket; the plain
        ingest occurs only where mid-series steps can (the widest
        bucket)."""
        return (self._solve._cache_size() + self._sweep._cache_size()
                + sum(b.ingest._cache_size() + b.ingest_solve._cache_size()
                      for b in self.buckets))

    @property
    def pending(self) -> int:
        return (sum(len(b.queue) for b in self.buckets)
                + sum(r is not None for b in self.buckets
                      for r in b.slot_req))

    # ----------------------------------------------------------------- run
    def _step_bucket(self, b: _Bucket) -> None:
        # admit: fill free slots from this bucket's queue
        for slot, req in enumerate(b.slot_req):
            if req is None and b.queue:
                b.slot_req[slot] = b.queue.pop(0)
                b.slot_pos[slot] = 0
                b.reset[slot] = True
                if self.obs.enabled:
                    uid = b.slot_req[slot].uid
                    self._admit_step[uid] = self._step_no
                    self.obs.tracer.instant(uid, "admit", self._step_no,
                                            bucket=b.width, slot=slot)
                    self.obs.tracer.begin(uid, "serve", self._step_no)
        active = [s for s, r in enumerate(b.slot_req) if r is not None]
        if not active:
            return

        n_slots, w = len(b.slot_req), b.width
        xh = np.zeros((n_slots, w), np.float32)
        yh = np.zeros((n_slots, w), np.float32)
        wh = np.zeros((n_slots, w), np.float32)
        rmask = np.zeros(n_slots, np.float32)
        loss_id = np.zeros(n_slots, np.int32)
        cval = np.ones(n_slots, np.float32)
        for s in active:
            req = b.slot_req[s]
            lo = int(b.slot_pos[s])
            chunk = req.x[lo:lo + w]
            m = chunk.shape[0]
            xh[s, :m] = chunk
            yh[s, :m] = req.y[lo:lo + w]
            wh[s, :m] = 1.0
            b.slot_pos[s] = lo + m
            self.points_ingested += m
            if req.spec.method == "irls":
                rmask[s] = 1.0
                loss_id[s] = robust_lib.LOSS_IDS[req.spec.irls.loss]
                cval[s] = robust_lib.resolve_tuning(req.spec.irls.loss,
                                                    req.spec.irls.c)
        keep = np.where(b.reset, 0.0, 1.0).astype(np.float32)
        b.reset[:] = False
        # readiness is known on the host BEFORE dispatch (slot_pos already
        # advanced): the fused ingest+solve when >= 1 request completes this
        # chunk, the plain ingest on mid-series steps
        ready = [s for s in active if b.slot_pos[s] >= b.slot_req[s].n]
        dev = self.device

        def card(a):
            return torch.from_numpy(a).to(dev)
        args = (card(xh), card(yh), card(wh), card(keep), rmask,
                card(loss_id), card(cval))
        if not ready:
            b.state = b.ingest(b.state, *args)
            return
        b.state, fused = b.ingest_solve(b.state, *args)
        # group ready slots by their request's spec: the default fixed
        # spec is already solved (fused above); every other DISTINCT spec
        # gets one solve for its whole group
        fixed_groups: dict[Any, list[int]] = {}
        auto_groups: dict[Any, list[int]] = {}
        for s in ready:
            groups = (auto_groups if b.slot_req[s].auto else fixed_groups)
            groups.setdefault(b.slot_req[s].spec, []).append(s)
        for spec, slots in fixed_groups.items():
            out = (fused if spec == self.fixed_spec
                   else self._solve(b.state, spec))
            solved = tuple(host(a) for a in out)
            for s in slots:
                req = b.slot_req[s]
                fill_fixed_result(req, spec, solved, s)
                b.slot_req[s] = None
                self._done(req)
        for spec, slots in auto_groups.items():
            outs = auto_outputs(*self._sweep(b.state, spec))
            crit = spec.degree.criterion or self.cfg.select_criterion
            for s in slots:
                req = b.slot_req[s]
                fill_auto_result(req, spec, outs, crit, s)
                b.slot_req[s] = None
                self._done(req)

    def _done(self, req: FitRequest) -> None:
        self.fits_done += 1
        self._m_completed.inc()
        self._h_points.observe(req.n)
        if self.obs.enabled:
            t0 = self._admit_step.pop(req.uid, self._step_no)
            self._h_latency.observe(self._step_no - t0)
            self.obs.tracer.end(req.uid, "serve", self._step_no)
            self.obs.tracer.instant(req.uid, "respond", self._step_no,
                                    steps=self._step_no - t0)

    def step(self) -> None:
        """One engine iteration: admit + one fused ingest+solve per
        non-empty bucket (+ one solve per distinct ready NON-default
        spec)."""
        self._step_no += 1
        for b in self.buckets:
            self._step_bucket(b)
        self._g_queue.set(sum(len(b.queue) for b in self.buckets))

    def run(self, max_steps: int = 1_000_000) -> None:
        """Drive until every queued request is served (or max_steps)."""
        for _ in range(max_steps):
            if not self.pending:
                return
            self.step()
        if self.pending:
            raise RuntimeError(f"{self.pending} requests still pending "
                               f"after {max_steps} steps")
