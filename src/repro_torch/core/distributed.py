"""Asynchronous LSPIA: barrier-free shard contributions (arXiv:2211.06556),
port of the asynchronous half of ``repro.core.distributed``.

The reference's synchronous half, a ``shard_map`` program whose every
Richardson sweep waits for the slowest shard's ``psum``, is the next slice
of ROADMAP.md Queue 1 item 12 (a ``torch.distributed`` mesh executor).
The asynchronous-LSPIA result says the iteration does not have to wait:
gradient contributions computed against *stale* coefficient versions
still drive it to the same least-squares fixed point as long as the
staleness is bounded.  This module realizes that on the fleet's
virtual-tick mailbox substrate: one coordinator, N ``AsyncLSPIAShard``
workers (each wrappable by ``runtime.chaos``'s ``ChaosWorker`` — same
protocol as ``serve.fleet``'s workers), per-shard sequence numbers for
idempotent delivery, and a staleness window outside which a shard's delta
is rejected and recomputed.  A chaos-stalled shard therefore delays
CONVERGENCE (its contribution is missing until it catches up) but never
blocks the coordinator's updates.

The shards' data and their gradients live on one device (``None`` means
CUDA); each delta comes back to the host, where the coordinator keeps the
iterate in float64 as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import basis as basis_lib
from repro_torch.core import fit as fit_lib
from repro_torch.core import lspia as lspia_lib
from repro_torch.device import as_tensor, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime import straggler as straggler_lib
from repro_torch.runtime.fault_tolerance import FailureDetector


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
    dom = spec.domain_or(
        basis_lib.Domain.from_data(x) if plan.numerics.normalize
        else basis_lib.Domain.identity(x.dtype, dev), dtype=x.dtype,
        device=dev)
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
