"""Fault-tolerant fit fleet: replicated workers behind one dispatcher
(port of ``repro.serve.fleet``).

``FitServeEngine`` next door is one synchronous process: a worker death
loses every in-flight series, one straggler stalls the batch loop, and
overload has nowhere to push back.  This module is the layer that makes
the ROADMAP's "millions of users" survivable:

* ``FleetWorker`` — a replicated fit worker speaking a mailbox protocol
  (``Ingest`` / ``Restore`` / ``Solve`` / ``Cancel`` in, ``Ack`` /
  ``Result`` out).  Each in-flight request is one spec-carrying
  ``StreamState`` on the fleet's device; the solve side reuses the
  *same* ``make_spec_solve`` / ``make_spec_sweep`` step functions as the
  single-process engine, so a fleet answer is the engine's answer.
  Every reply leaves the worker as host numpy: the dispatcher never
  touches device memory.
* ``FitFleet`` — the dispatcher: routes requests to the least-loaded
  live worker, detects death by missed heartbeats
  (``runtime.fault_tolerance.FailureDetector``), retries silently
  dropped chunks, hedges requests stuck on fitted-step-time-verdicted
  stragglers (the paper's own LSE doing fleet introspection), restarts
  crashed workers under a jittered ``RestartPolicy``, and validates
  every reply — a poisoned (non-finite) result quarantines its worker
  and is re-solved elsewhere instead of reaching the caller.
* the **moment journal** — because ``Moments`` is additive and O(m²),
  each chunk ack carries a snapshot of the request's accumulated state
  (``StreamState.snapshot``, a few hundred bytes).  A worker death
  mid-ingest replays from the last snapshot on a survivor instead of
  re-reading the data, and idempotent (request-key, chunk-seq) delivery
  means a retried chunk is acked, never re-accumulated: replay cannot
  double-count, so a faulted run returns bit-identical coefficients to
  a fault-free one (the chaos parity invariant, tested).
* **graceful degradation** — a bounded admission queue sheds beyond
  ``max_queue``, but first (beyond ``degrade_watermark``) DegreeSearch
  requests are downgraded to fixed-degree fits — cheaper to serve, and
  the downgrade is surfaced in the result metadata (``req.degraded``)
  rather than silently applied.

Time is an injected virtual tick clock — the scheduling loop never
sleeps — so every recovery path above is exercised deterministically by
``runtime.chaos`` fault schedules.  The asynchronous-LSPIA result
(arXiv:2211.06556) is why this is safe for the *fit itself*: moment
accumulation tolerates reordered and partial contributions, so the only
invariant the dispatcher must police is exactly-once accumulation — the
journal's job.

On the card the chaos parity holds bit for bit because the moment
kernels use no atomics, ``snapshot()`` → ``restore()`` is bit-equal, and
a replayed or hedged copy runs the same ops on the same chunk boundaries.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any

import numpy as np

from repro_torch.api.spec import ServicePolicy
from repro_torch.core import streaming
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import slo as slo_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime.fault_tolerance import (FailureDetector,
                                                 RestartPolicy)
from repro_torch.serve import fit_engine as fe

# every fleet counter, predefined so ``stats`` always exposes the full
# vocabulary (a zero count is an assertable fact, not a missing key)
_STAT_KEYS = (
    "completed", "shed", "degraded", "failed", "replays", "hedges",
    "hedge_wins", "hedge_losses", "resends", "retries_timeout",
    "retries_invalid", "poisoned", "worker_deaths", "revivals",
    "async_harvests", "async_updates",
)

# ----------------------------------------------------------------- protocol


class ProtocolError(RuntimeError):
    """A message whose ``kind`` no dispatcher branch claims.  The mailbox
    vocabulary is closed-world — ``repro.analysis``'s RL-PROTOCOL checker
    verifies every constructed kind has a handler and every dispatcher
    raises this instead of silently dropping (a dropped *reply* is
    unrecoverable: no timeout fires on it)."""

    def __init__(self, where: str, kind):
        self.where = where
        self.kind = kind
        super().__init__(f"{where}: unknown message kind {kind!r}")


@dataclasses.dataclass
class Ingest:
    """Chunk ``seq`` (1-based) of request ``key``; ``w`` masks padding."""
    key: int
    seq: int
    x: np.ndarray
    y: np.ndarray
    w: np.ndarray
    spec: Any
    want_snapshot: bool = True
    kind: str = "ingest"


@dataclasses.dataclass
class Restore:
    """Reset request ``key`` to the journaled state after chunk ``seq``."""
    key: int
    seq: int
    snapshot: dict | None
    spec: Any
    kind: str = "restore"


@dataclasses.dataclass
class Solve:
    key: int
    spec: Any
    kind: str = "solve"


@dataclasses.dataclass
class Cancel:
    key: int
    kind: str = "cancel"


@dataclasses.dataclass
class Ack:
    """Worker's applied watermark for ``key`` (idempotence: a duplicate or
    out-of-window chunk is acked at the current watermark, never
    re-accumulated)."""
    key: int
    seq: int
    snapshot: dict | None
    worker: int
    kind: str = "ack"


@dataclasses.dataclass
class Result:
    key: int
    worker: int
    fixed: tuple | None = None   # make_spec_solve outputs (numpy)
    auto: dict | None = None     # auto_outputs dict
    kind: str = "result"

    def poisoned(self) -> "Result":
        """The chaos injector's silent-corruption fault: same reply shape,
        NaN coefficients."""
        msg = dataclasses.replace(self)
        if msg.fixed is not None:
            c = np.full_like(np.asarray(msg.fixed[0]), np.nan)
            msg.fixed = (c,) + tuple(msg.fixed[1:])
        if msg.auto is not None:
            outs = dict(msg.auto)
            outs["ladder"] = np.full_like(outs["ladder"], np.nan)
            msg.auto = outs
        return msg


# ------------------------------------------------------------------ request


@dataclasses.dataclass
class FleetRequest(fe.FitRequest):
    """A ``FitRequest`` plus the fleet's service metadata: every recovery
    or degradation action taken on this request's behalf is surfaced."""

    service: ServicePolicy = ServicePolicy()
    degraded: str | None = None    # e.g. "degree_search->fixed"
    shed: bool = False             # rejected at admission (queue bound)
    failed: str | None = None      # terminal error ("deadline", ...)
    retries: int = 0               # resends + invalid-result retries
    replays: int = 0               # journal replays onto another worker
    hedged: bool = False           # duplicate-dispatched for a straggler
    admit_tick: int = -1
    done_tick: int = -1
    workers: list[int] = dataclasses.field(default_factory=list)

    @property
    def latency_ticks(self) -> int:
        return self.done_tick - self.admit_tick


@dataclasses.dataclass
class AsyncFitHandle:
    """Parent handle for one sharded async-LSPIA submission
    (``FitFleet.submit_async_lspia``).

    Each shard is an ordinary child ``FleetRequest`` riding the existing
    journal machinery (per-shard chunk sequence numbers, idempotent
    delivery, snapshot replay); the dispatcher harvests a shard's final
    journal snapshot the moment its ingest completes — no ``Solve``
    round-trip — and re-solves the merged moment state with moment-space
    LSPIA after EVERY harvest.  ``coeffs`` therefore progresses while a
    chaos-stalled shard's contribution is still missing
    (``updates_while_partial`` counts those partial re-solves); ``done``
    only once every shard has landed, so the final answer is exact."""

    uid: int
    spec: Any
    n_shards: int
    shard_uids: list[int] = dataclasses.field(default_factory=list)
    harvested: int = 0
    updates: int = 0
    updates_while_partial: int = 0
    coeffs: np.ndarray | None = None
    sse: float | None = None
    r: float | None = None
    count: float | None = None
    condition: float | None = None
    converged: bool = False
    failed: str | None = None
    done: bool = False
    done_tick: int = -1


# ------------------------------------------------------------------- worker


class FleetWorker:
    """One replicated fit worker: per-request spec-carrying stream states
    on ``device`` (``None`` means CUDA) plus the pool's shared solve/sweep
    step functions.

    Stateless between requests except for the states it is explicitly
    ingesting — ``reset()`` (crash, restart) drops everything, which is
    safe because the dispatcher's journal owns durability."""

    def __init__(self, worker_id: int, pool_specs: fe.PoolSpecs,
                 dtype, solve, sweep, *, device=None):
        self.worker_id = worker_id
        self.pool = pool_specs.pool
        self.dtype = dtype
        self.device = resolve_device(device)
        self._solve = solve
        self._sweep = sweep
        self.states: dict[int, streaming.StreamState] = {}
        self.applied: dict[int, int] = {}
        self.snaps: dict[int, dict | None] = {}
        self.processed = 0

    def reset(self) -> None:
        self.states.clear()
        self.applied.clear()
        self.snaps.clear()

    def _accum_spec(self, rspec):
        """The spec the request's state accumulates under: the request's
        own method/basis/numerics at the POOL degree, so nested degrees
        and DegreeSearch ladders are truncate views — exactly the
        single-process engine's accumulation contract."""
        if rspec.max_degree == self.pool.max_degree \
                and not rspec.is_search:
            return rspec
        return dataclasses.replace(rspec, degree=self.pool.max_degree)

    def process(self, msg, tick: int) -> list:
        self.processed += 1
        key = msg.key
        if msg.kind == "ingest":
            applied = self.applied.get(key, 0)
            if msg.seq != applied + 1:
                # duplicate (<= applied) or out-of-window: ack the
                # watermark, touch nothing — the idempotence that makes
                # journal replay and retry racing safe
                return [Ack(key, applied, self.snaps.get(key),
                            self.worker_id)]
            st = self.states.get(key)
            if st is None:
                st = streaming.StreamState.create(
                    self.pool.max_degree, (), decay=self.pool.decay,
                    dtype=self.dtype, spec=self._accum_spec(msg.spec),
                    device=self.device)
            st = streaming.update(st, msg.x, msg.y, weights=msg.w)
            self.states[key] = st
            self.applied[key] = msg.seq
            snap = st.snapshot() if msg.want_snapshot else None
            if snap is not None:
                self.snaps[key] = snap
            return [Ack(key, msg.seq, snap, self.worker_id)]
        if msg.kind == "restore":
            if msg.seq == 0 or msg.snapshot is None:
                st = streaming.StreamState.create(
                    self.pool.max_degree, (), decay=self.pool.decay,
                    dtype=self.dtype, spec=self._accum_spec(msg.spec),
                    device=self.device)
                self.snaps[key] = None
            else:
                st = streaming.StreamState.restore(
                    msg.snapshot, spec=self._accum_spec(msg.spec),
                    device=self.device)
                self.snaps[key] = msg.snapshot
            self.states[key] = st
            self.applied[key] = msg.seq
            return [Ack(key, msg.seq, self.snaps.get(key), self.worker_id)]
        if msg.kind == "solve":
            st = self.states.get(key)
            if st is None:
                # state lost (restarted worker got a stale solve): stay
                # silent — the dispatcher's timeout replays from the
                # journal
                return []
            if msg.spec.is_search:
                outs = fe.auto_outputs(*self._sweep(st, msg.spec))
                return [Result(key, self.worker_id, auto=outs)]
            solved = tuple(fe.host(a) for a in self._solve(st, msg.spec))
            return [Result(key, self.worker_id, fixed=solved)]
        if msg.kind == "cancel":
            self.states.pop(key, None)
            self.applied.pop(key, None)
            self.snaps.pop(key, None)
            return []
        raise ProtocolError(f"worker {self.worker_id}", msg.kind)


# --------------------------------------------------------------- dispatcher


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Dispatcher policy.  ``fit`` supplies the pool spec family (degree,
    basis, solver ladder, decay — same vocabulary as the single-process
    engine); everything else is fleet mechanics in virtual ticks."""

    fit: fe.FitServeConfig = fe.FitServeConfig()
    n_workers: int = 4
    chunk_width: int = 256
    max_inflight: int = 4           # concurrent requests per worker
    max_queue: int = 1024           # admission bound: shed beyond this
    degrade_watermark: int | None = None   # default max_queue // 2:
    # DegreeSearch requests admitted above this backlog run fixed-degree
    service: ServicePolicy = ServicePolicy()
    work_per_tick: int = 2          # mailbox messages per worker per tick
    heartbeat_timeout: float = 4.0  # ticks without a beat = dead
    straggler_every: int = 4        # fitted step-time observation cadence
    straggler_threshold: float = 3.0
    quarantine_ticks: int = 16      # poisoned-reply penalty box
    max_restarts: int = 2           # per-worker revival budget
    restart_backoff: float = 4.0    # base backoff in ticks (jittered)
    max_restart_backoff: float = 32.0
    snapshot_every: int = 1         # journal granularity in chunks
    parallel_pump: bool = False     # pump worker mailboxes in threads
    seed: int = 0                   # restart-jitter determinism
    chaos: chaos_lib.ChaosSchedule | None = None
    trace: bool = False             # record per-request trace spans
    slo_p99: float | None = None    # watch latency_ticks:p99 vs this SLO
    slo_every: int = 8              # SLO observation cadence in ticks

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got "
                             f"{self.n_workers}")
        if self.chunk_width < 1 or self.max_inflight < 1 \
                or self.work_per_tick < 1 or self.snapshot_every < 1:
            raise ValueError("chunk_width/max_inflight/work_per_tick/"
                             "snapshot_every must all be >= 1")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{self.max_queue}")
        dw = self.degrade_watermark
        if dw is not None and not 0 <= dw <= self.max_queue:
            raise ValueError(f"degrade_watermark={dw} must lie in "
                             f"[0, max_queue={self.max_queue}]")
        if self.slo_every < 1:
            raise ValueError(f"slo_every must be >= 1, got "
                             f"{self.slo_every}")


@dataclasses.dataclass
class _Assignment:
    """One worker's copy of one request (two exist while hedged)."""
    worker: int
    acked: int               # chunks this worker has applied
    last_progress: int       # tick of last forward progress
    resends: int = 0
    solving: bool = False


@dataclasses.dataclass
class _Flight:
    """One admitted request in service: its pre-split chunks, the moment
    journal (highest snapshotted seq + snapshot), and its assignments."""
    req: FleetRequest
    chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
    journal_seq: int = 0
    journal_snap: dict | None = None
    assignments: list[_Assignment] = dataclasses.field(default_factory=list)
    hedge_workers: set[int] = dataclasses.field(default_factory=set)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)


class FitFleet:
    """The dispatcher: N chaos-wrappable ``FleetWorker``s, one virtual
    clock, and a recovery policy for every fault class the chaos injector
    can throw (see module docstring).  Workers, the straggler fit and the
    SLO board live on ``device`` (``None`` means CUDA)."""

    def __init__(self, cfg: FleetConfig | None = None, *, device=None):
        self.cfg = cfg = cfg or FleetConfig()
        self.device = resolve_device(device)
        self.pool_specs = fe.derive_pool_specs(cfg.fit)
        self.spec = self.pool_specs.pool
        pool_degree = self.spec.max_degree
        self._solve = fe.make_spec_solve(pool_degree)
        self._sweep = fe.make_spec_sweep(pool_degree)
        schedule = cfg.chaos or chaos_lib.ChaosSchedule()
        self.workers = [
            chaos_lib.ChaosWorker(
                FleetWorker(w, self.pool_specs, cfg.fit.dtype,
                            self._solve, self._sweep, device=self.device),
                w, schedule.for_worker(w))
            for w in range(cfg.n_workers)]
        self._inbox: list[list] = [[] for _ in range(cfg.n_workers)]
        self._replies: list[tuple[int, int, Any]] = []   # (due, n, reply)
        self._reply_seq = 0
        self._queue: list[FleetRequest] = []
        self._flights: dict[int, _Flight] = {}
        self._uid = 0
        self.tick = 0
        self.fits_done = 0
        self.points_ingested = 0
        self.detector = FailureDetector(
            cfg.n_workers, timeout_s=cfg.heartbeat_timeout,
            straggler_threshold=cfg.straggler_threshold, device=self.device)
        self._restart = [
            RestartPolicy(max_restarts=cfg.max_restarts,
                          base_backoff_s=cfg.restart_backoff,
                          max_backoff_s=cfg.max_restart_backoff,
                          seed=cfg.seed * 1000 + w)
            for w in range(cfg.n_workers)]
        self._down: set[int] = set()
        self._revive_at: dict[int, int] = {}
        self._quarantined_until = [0] * cfg.n_workers
        self._stragglers: set[int] = set()
        # per-worker service-time model feeding the fitted verdicts
        self._ema = np.ones(cfg.n_workers)
        self._last_reply = np.zeros(cfg.n_workers)
        self._obs_step = 0
        self._pool = None
        if cfg.parallel_pump:
            from concurrent.futures import ThreadPoolExecutor
            if self.device.type == "cuda":
                # build the kernels here, before any pump thread exists
                from repro_torch.kernels import build
                build.library()
            self._pool = ThreadPoolExecutor(max_workers=cfg.n_workers)
        # observability: the registry is always live (counter increments
        # cost what the old dict increments cost, and the stats contract
        # below reads from it); the tracer is opt-in via cfg.trace
        self.metrics = obs_metrics.MetricsRegistry()
        self._counters = {k: self.metrics.counter(k) for k in _STAT_KEYS}
        self._lat = self.metrics.histogram("latency_ticks")
        self._queue_depth = self.metrics.gauge("queue_depth")
        self.tracer = (trace_lib.Tracer() if cfg.trace
                       else trace_lib.NULL_TRACER)
        self.slo = slo_lib.SLOBoard(self.metrics, device=self.device)
        if cfg.slo_p99 is not None:
            self.slo.watch("latency_ticks:p99", cfg.slo_p99)
        # sharded async-LSPIA parents: child uid -> (handle, shard index),
        # and the per-parent harvested shard snapshots
        self._async_children: dict[int, tuple[AsyncFitHandle, int]] = {}
        self._async_snaps: dict[int, dict[int, dict]] = {}

    # ------------------------------------------------------------ admission
    @property
    def degrade_watermark(self) -> int:
        dw = self.cfg.degrade_watermark
        return self.cfg.max_queue // 2 if dw is None else dw

    def submit(self, x, y, *, degree: int | str | None = None,
               spec=None, service: ServicePolicy | None = None
               ) -> FleetRequest:
        """Queue one series.  Overload policy at admission: beyond
        ``degrade_watermark`` queued requests, DegreeSearch work is
        downgraded to a fixed-degree fit (surfaced in ``req.degraded``);
        beyond ``max_queue`` the request is shed outright
        (``req.shed``)."""
        rspec = fe.resolve_request_spec(self.pool_specs, degree, spec)
        x, y = fe.validate_series(x, y, rspec)
        req = FleetRequest(self._uid, x, y, spec=rspec,
                           auto=rspec.is_search,
                           service=service or self.cfg.service)
        self._uid += 1
        backlog = len(self._queue)
        self.tracer.instant(req.uid, "submit", self.tick, n=int(req.n),
                            auto=bool(req.auto))
        if backlog >= self.cfg.max_queue:
            req.shed = True
            req.failed = "shed"
            req.done = True
            self._counters["shed"].inc()
            self.tracer.instant(req.uid, "shed", self.tick,
                                backlog=backlog)
            return req
        if backlog >= self.degrade_watermark and rspec.is_search:
            req.spec = dataclasses.replace(rspec,
                                           degree=rspec.max_degree)
            req.auto = False
            req.degraded = "degree_search->fixed"
            self._counters["degraded"].inc()
            self.tracer.instant(req.uid, "degrade", self.tick,
                                what="degree_search->fixed",
                                backlog=backlog)
        self._queue.append(req)
        self.tracer.begin(req.uid, "queue", self.tick)
        self._queue_depth.set(len(self._queue))
        return req

    def submit_async_lspia(self, x, y, *, spec=None,
                           n_shards: int = 2) -> AsyncFitHandle:
        """Queue one series as ``n_shards`` barrier-free shard ingests
        (asynchronous LSPIA, arXiv:2211.06556).

        Each shard is an ordinary child request — its chunks carry the
        journal's per-shard sequence numbers, so retry/replay/idempotence
        all work unchanged — but the dispatcher intercepts the completed
        ingest journal instead of sending a ``Solve``: the shard's final
        moment snapshot is harvested, merged with the other shards'
        (moments are additive), and the merged state is re-solved with
        moment-space LSPIA (momentum included) after every harvest.  A
        chaos-stalled worker therefore delays only its own shard's
        contribution: the handle's ``coeffs`` keep updating from the
        shards already in hand, and the exact answer lands when the
        straggler does.  Requires a ``method="lspia"`` spec (default:
        the pool spec switched to LSPIA) and a non-forgetting pool
        (``decay == 1.0`` — shard chunks interleave arbitrarily)."""
        if self.spec.decay != 1.0:
            raise ValueError(
                "sharded async ingest has no global age order: the pool "
                f"must not decay (decay={self.spec.decay})")
        if spec is None:
            spec = dataclasses.replace(self.pool_specs.fixed,
                                       method="lspia")
        rspec = fe.resolve_request_spec(self.pool_specs, None, spec)
        if rspec.method != "lspia":
            raise ValueError(f"submit_async_lspia needs method='lspia', "
                             f"got {rspec.method!r}")
        if rspec.is_search:
            raise ValueError("async LSPIA serves fixed degrees; use "
                             "degree='auto' on plain submit")
        x, y = fe.validate_series(x, y, rspec)
        if x.shape[0] < n_shards:
            raise ValueError(f"{x.shape[0]} points cannot fill "
                             f"{n_shards} shards")
        handle = AsyncFitHandle(uid=self._uid, spec=rspec,
                                n_shards=n_shards)
        self._uid += 1
        bounds = np.linspace(0, x.shape[0], n_shards + 1).astype(int)
        for s in range(n_shards):
            sl = slice(bounds[s], bounds[s + 1])
            child = self.submit(x[sl], y[sl], spec=rspec)
            handle.shard_uids.append(child.uid)
            if child.shed:
                handle.failed = "shed"
                handle.done = True
                return handle
            self._async_children[child.uid] = (handle, s)
        self._async_snaps[handle.uid] = {}
        return handle

    def warmup(self) -> int:
        """Run the default step functions (ingest update + fixed solve +
        auto sweep) once through the full dispatch path; returns
        ``compiled_executables()`` — the no-new-key baseline."""
        if self._queue or self._flights:
            raise RuntimeError("warmup() requires an idle fleet")
        n = max(self.cfg.chunk_width, self.spec.max_degree + 1)
        x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
        self.submit(x, x, spec=self.pool_specs.fixed)
        self.submit(x, x, spec=self.pool_specs.auto)
        self.run()
        return self.compiled_executables()

    def compiled_executables(self) -> int:
        """Distinct (step, argument signature) keys of the solve/sweep step
        functions, shared by ALL workers (replication adds none): the
        count the reference's jit caches hold for the same traffic."""
        return self._solve._cache_size() + self._sweep._cache_size()

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._flights)

    @property
    def stats(self) -> dict:
        """Event counts, read live from the metrics registry (the old
        ad-hoc dict's contract, now one view over first-class metrics)."""
        return {k: c.value for k, c in self._counters.items()}

    # ------------------------------------------------------------- helpers
    def _split_chunks(self, req: FleetRequest):
        w = self.cfg.chunk_width
        out = []
        for lo in range(0, req.n, w):
            xs = req.x[lo:lo + w]
            m = xs.shape[0]
            xc = np.zeros(w, np.float32)
            yc = np.zeros(w, np.float32)
            wc = np.zeros(w, np.float32)
            xc[:m] = xs
            yc[:m] = req.y[lo:lo + w]
            wc[:m] = 1.0
            out.append((xc, yc, wc))
        return out

    def _alive(self, w: int) -> bool:
        return self.workers[w].alive and w not in self._down

    def _eligible(self, w: int) -> bool:
        return (self._alive(w)
                and self._quarantined_until[w] <= self.tick)

    def _load(self, w: int) -> int:
        return sum(1 for fl in self._flights.values()
                   for a in fl.assignments if a.worker == w)

    def _pick_worker(self, exclude: set[int] = frozenset(),
                     respect_capacity: bool = False) -> int | None:
        cand = [w for w in range(self.cfg.n_workers)
                if self._eligible(w) and w not in exclude]
        healthy = [w for w in cand if w not in self._stragglers]
        cand = healthy or cand
        if respect_capacity:
            cand = [w for w in cand
                    if self._load(w) < self.cfg.max_inflight]
        if not cand:
            return None
        return min(cand, key=lambda w: (self._load(w), w))

    def _send(self, w: int, msg) -> None:
        self._inbox[w].append(msg)

    def _send_next(self, fl: _Flight, asg: _Assignment) -> None:
        """Advance one assignment: next chunk, or the solve."""
        req = fl.req
        if asg.acked >= fl.n_chunks:
            if req.uid in self._async_children:
                # async-LSPIA shard whose journal lags its ack watermark
                # (sparse snapshots): re-ask for the last chunk — the
                # worker's duplicate-ack carries its latest snapshot and
                # never re-accumulates, so the journal catches up
                x, y, w_ = fl.chunks[-1]
                self._send(asg.worker, Ingest(req.uid, fl.n_chunks, x, y,
                                              w_, req.spec,
                                              want_snapshot=True))
                return
            if not asg.solving:
                asg.solving = True
                self.tracer.end(req.uid, "ingest", self.tick)
                self.tracer.begin(req.uid, "solve", self.tick,
                                  worker=asg.worker)
                self._send(asg.worker, Solve(req.uid, req.spec))
            return
        seq = asg.acked + 1
        x, y, w_ = fl.chunks[seq - 1]
        want = (seq % self.cfg.snapshot_every == 0
                or seq == fl.n_chunks)
        self._send(asg.worker, Ingest(req.uid, seq, x, y, w_, req.spec,
                                      want_snapshot=want))

    def _assign(self, fl: _Flight, worker: int) -> None:
        """Start (or restart) the request on ``worker`` from the journal."""
        asg = _Assignment(worker=worker, acked=fl.journal_seq,
                          last_progress=self.tick)
        fl.assignments.append(asg)
        fl.req.workers.append(worker)
        if fl.journal_seq > 0:
            self._send(worker, Restore(fl.req.uid, fl.journal_seq,
                                       fl.journal_snap, fl.req.spec))
        else:
            self._send_next(fl, asg)

    def _drop_assignment(self, fl: _Flight, asg: _Assignment,
                         cancel: bool = True) -> None:
        fl.assignments.remove(asg)
        if cancel and self._alive(asg.worker):
            self._send(asg.worker, Cancel(fl.req.uid))

    def _replay(self, fl: _Flight, exclude: set[int]) -> None:
        """Journal replay: resume the request on a fresh worker from the
        last snapshot — no data re-read, no double accumulation."""
        w = self._pick_worker(exclude)
        if w is None:
            return      # retried next tick (flight has no assignment)
        fl.req.replays += 1
        self._counters["replays"].inc()
        self.tracer.instant(fl.req.uid, "replay", self.tick, worker=w,
                            from_seq=fl.journal_seq)
        self._assign(fl, w)

    def _fail(self, fl: _Flight, reason: str) -> None:
        for asg in list(fl.assignments):
            self._drop_assignment(fl, asg)
        fl.req.failed = reason
        fl.req.done = True
        fl.req.done_tick = self.tick
        self._flights.pop(fl.req.uid)
        self._counters["failed"].inc()
        self.tracer.end(fl.req.uid, "ingest", self.tick)
        self.tracer.end(fl.req.uid, "solve", self.tick)
        self.tracer.instant(fl.req.uid, "failed", self.tick,
                            reason=reason)
        entry = self._async_children.pop(fl.req.uid, None)
        if entry is not None:
            # a lost shard makes the parent's exact answer unreachable:
            # surface the failure, keep the last partial coefficients
            handle, _ = entry
            handle.failed = reason
            handle.done = True
            handle.done_tick = self.tick
            self._async_snaps.pop(handle.uid, None)

    # ------------------------------------------------------------ the loop
    def step(self) -> None:
        """One virtual tick: revive → heartbeat → admit → pump mailboxes →
        handle replies → failure/straggler verdicts → timeouts."""
        cfg = self.cfg
        self.tick += 1
        tick = self.tick
        for w, due in list(self._revive_at.items()):
            if due <= tick:
                del self._revive_at[w]
                self.workers[w].revive()
                self._inbox[w].clear()    # a restarted worker's stale
                # mail targets state it no longer holds
                self._down.discard(w)
                self.detector.hb.beat(w, float(tick))
                self._counters["revivals"].inc()
                self.tracer.instant(trace_lib.FLEET_UID, "revival", tick,
                                    worker=w)
        for w, wk in enumerate(self.workers):
            wk.begin_tick(tick)
            if wk.alive:
                self.detector.hb.beat(w, float(tick))
        # admit queued requests onto workers with capacity
        while self._queue:
            w = self._pick_worker(respect_capacity=True)
            if w is None:
                break
            req = self._queue.pop(0)
            req.admit_tick = tick
            self.tracer.end(req.uid, "queue", tick)
            self.tracer.instant(req.uid, "admit", tick, worker=w)
            self.tracer.begin(req.uid, "ingest", tick, worker=w)
            fl = _Flight(req=req, chunks=self._split_chunks(req))
            self._flights[req.uid] = fl
            self._assign(fl, w)
        self._queue_depth.set(len(self._queue))
        self._pump(tick)
        self._handle_replies(tick)
        self._verdicts(tick)
        self._timeouts(tick)
        if self.slo.monitors and tick % cfg.slo_every == 0:
            self.slo.update(tick)

    def _pump_one(self, w: int, tick: int) -> list[tuple[int, Any]]:
        wk = self.workers[w]
        if not wk.alive or wk.stalled(tick):
            return []
        out = []
        for _ in range(self.cfg.work_per_tick):
            if not self._inbox[w]:
                break
            msg = self._inbox[w].pop(0)
            out.extend(wk.process(msg, tick))
        return out

    def _pump(self, tick: int) -> None:
        """Drain up to ``work_per_tick`` messages per worker.  With
        ``parallel_pump`` the workers run in threads behind a per-tick
        barrier — real thread parallelism, same deterministic reply order
        (replies are merged in worker-id order)."""
        if self._pool is not None:
            batches = list(self._pool.map(
                lambda w: self._pump_one(w, tick),
                range(self.cfg.n_workers)))
        else:
            batches = [self._pump_one(w, tick)
                       for w in range(self.cfg.n_workers)]
        for batch in batches:
            for delay, rep in batch:
                heapq.heappush(self._replies,
                               (tick + delay, self._reply_seq, rep))
                self._reply_seq += 1

    def _handle_replies(self, tick: int) -> None:
        while self._replies and self._replies[0][0] <= tick:
            _, _, rep = heapq.heappop(self._replies)
            w = rep.worker
            if self._last_reply[w] > 0:
                gap = max(1.0, tick - self._last_reply[w])
                self._ema[w] = 0.5 * self._ema[w] + 0.5 * gap
            self._last_reply[w] = tick
            fl = self._flights.get(rep.key)
            if fl is None:
                # late reply for a finished request: GC the worker copy
                if self._alive(w):
                    self._send(w, Cancel(rep.key))
                continue
            if rep.kind == "ack":
                self._on_ack(fl, rep, tick)
            elif rep.kind == "result":
                self._on_result(fl, rep, tick)
            else:
                raise ProtocolError("dispatcher", rep.kind)

    def _on_ack(self, fl: _Flight, ack: Ack, tick: int) -> None:
        asg = next((a for a in fl.assignments if a.worker == ack.worker),
                   None)
        if asg is None:
            return
        if ack.seq > asg.acked:
            if asg.acked < fl.n_chunks:
                self.points_ingested += int(
                    np.sum(fl.chunks[ack.seq - 1][2] > 0))
            asg.acked = ack.seq
            asg.resends = 0
        asg.last_progress = tick
        if (ack.seq > fl.journal_seq and ack.snapshot is not None):
            fl.journal_seq = ack.seq
            fl.journal_snap = ack.snapshot
        entry = self._async_children.get(fl.req.uid)
        if entry is not None and fl.journal_seq >= fl.n_chunks:
            # async-LSPIA shard: the completed ingest journal IS the
            # contribution — harvest it, no Solve round-trip
            self._harvest_shard(fl, *entry, tick)
            return
        self._send_next(fl, asg)

    # ------------------------------------------------- async-LSPIA shards
    def _accum_spec(self, rspec):
        """Dispatcher-side copy of ``FleetWorker._accum_spec``: snapshots
        accumulate at the pool degree."""
        if rspec.max_degree == self.spec.max_degree and not rspec.is_search:
            return rspec
        return dataclasses.replace(rspec, degree=self.spec.max_degree)

    def _harvest_shard(self, fl: _Flight, handle: AsyncFitHandle,
                       shard: int, tick: int) -> None:
        req = fl.req
        req.done = True
        req.done_tick = tick
        for asg in list(fl.assignments):
            self._drop_assignment(fl, asg)   # Cancel frees worker state
        self._flights.pop(req.uid)
        self._async_children.pop(req.uid, None)
        snaps = self._async_snaps.get(handle.uid)
        if snaps is None or handle.done:
            return
        if shard not in snaps:
            snaps[shard] = fl.journal_snap
            handle.harvested += 1
            self._counters["async_harvests"].inc()
        self.tracer.end(req.uid, "ingest", tick)
        self.tracer.instant(req.uid, "respond", tick,
                            kind="async_harvest", shard=shard,
                            parent=handle.uid)
        self._async_resolve(handle, tick)

    def _async_resolve(self, handle: AsyncFitHandle, tick: int) -> None:
        """Merge the harvested shard snapshots (moments are additive) and
        re-solve with moment-space LSPIA — partial shards give a partial
        (progressing) answer, the full set the exact one."""
        snaps = self._async_snaps.get(handle.uid)
        if not snaps:
            return
        parts = list(snaps.values())
        # reprolint: disable=RL-DTYPE — shard merge sums in f64, then casts
        merged = {k: sum(np.asarray(p[k], np.float64) for p in parts)
                  .astype(parts[0][k].dtype)
                  for k in ("gram", "vty", "yty", "count", "weight_sum")}
        merged["decay"] = parts[0]["decay"]
        st = streaming.StreamState.restore(
            merged, spec=self._accum_spec(handle.spec), device=self.device)
        solved = tuple(fe.host(a) for a in self._solve(st, handle.spec))
        coeffs, sse, r, count, cond, fb = solved
        if not np.all(np.isfinite(coeffs)):
            return      # partial state degenerate: keep the last answer
        d = int(handle.spec.degree)
        handle.coeffs = coeffs[:d + 1].copy()
        handle.sse = float(sse)
        handle.r = float(r)
        handle.count = float(count)
        handle.condition = float(cond)
        handle.converged = not bool(fb)
        handle.updates += 1
        self._counters["async_updates"].inc()
        if handle.harvested < handle.n_shards:
            handle.updates_while_partial += 1
        else:
            handle.done = True
            handle.done_tick = tick
            self.fits_done += 1
            self._counters["completed"].inc()
            self._async_snaps.pop(handle.uid, None)

    def _valid(self, req: FleetRequest) -> bool:
        return (req.coeffs is not None
                and bool(np.all(np.isfinite(req.coeffs)))
                and np.isfinite(req.sse))

    def _on_result(self, fl: _Flight, rep: Result, tick: int) -> None:
        req = fl.req
        if rep.fixed is not None:
            fe.fill_fixed_result(req, req.spec, rep.fixed)
        else:
            crit = (req.spec.degree.criterion
                    or self.pool_specs.select_criterion)
            fe.fill_auto_result(req, req.spec, rep.auto, crit)
        if self._valid(req):
            req.done_tick = tick
            self._lat.observe(req.latency_ticks)
            if req.hedged:
                won = ("hedge_wins" if rep.worker in fl.hedge_workers
                       else "hedge_losses")
                self._counters[won].inc()
            for asg in list(fl.assignments):
                self._drop_assignment(fl, asg)
            self._flights.pop(req.uid)
            self.fits_done += 1
            self._counters["completed"].inc()
            self.tracer.end(req.uid, "solve", tick, worker=rep.worker)
            self.tracer.instant(req.uid, "respond", tick,
                                worker=rep.worker,
                                latency_ticks=int(req.latency_ticks))
            return
        # poisoned / corrupt reply: quarantine the producer, scrub the
        # request, and re-solve from the journal on someone else
        req.done = False
        req.coeffs = None
        req.sse = req.r = req.condition = None
        req.degree = None
        req.scores = req.condition_ladder = None
        self._counters["poisoned"].inc()
        self._counters["retries_invalid"].inc()
        self.tracer.instant(req.uid, "poisoned", tick, worker=rep.worker)
        self.tracer.instant(req.uid, "retry", tick,
                            cause="invalid-result", worker=rep.worker)
        self.tracer.end(req.uid, "solve", tick)
        req.retries += 1
        self._quarantined_until[rep.worker] = (
            tick + self.cfg.quarantine_ticks)
        bad = next((a for a in fl.assignments
                    if a.worker == rep.worker), None)
        if bad is not None:
            self._drop_assignment(fl, bad)
        if req.retries > req.service.max_retries:
            self._fail(fl, "invalid-result")
        elif not fl.assignments:
            self._replay(fl, exclude={rep.worker})

    def _verdicts(self, tick: int) -> None:
        """Drive ``FailureDetector`` end-to-end: heartbeat death →
        journal replay + jittered restart; fitted step-time straggler →
        hedged duplicate dispatch."""
        cfg = self.cfg
        if tick % cfg.straggler_every == 0:
            obs = np.array([
                max(self._ema[w], tick - self._last_reply[w])
                if (self._inbox[w] or any(
                    a.worker == w for fl in self._flights.values()
                    for a in fl.assignments)) and self._alive(w)
                else self._ema[w]
                for w in range(cfg.n_workers)])
            self.detector.steptime.observe(self._obs_step, obs)
            self._obs_step += 1
        verdict = self.detector.verdict(self._obs_step, now=float(tick))
        self._stragglers = {w for w in verdict["stragglers"]
                            if self._alive(w)}
        for w in verdict["dead"]:
            if w in self._down:
                continue
            self._down.add(w)
            self._counters["worker_deaths"].inc()
            self.tracer.instant(trace_lib.FLEET_UID, "worker_death", tick,
                                worker=w)
            backoff = self._restart[w].next_backoff()
            if backoff is not None:
                self._revive_at[w] = tick + int(np.ceil(backoff))
            for fl in list(self._flights.values()):
                lost = [a for a in fl.assignments if a.worker == w]
                for asg in lost:
                    self._drop_assignment(fl, asg, cancel=False)
                if lost and not fl.assignments:
                    self._replay(fl, exclude={w})
        if self._stragglers:
            for fl in self._flights.values():
                if (fl.req.service.hedge and not fl.req.hedged
                        and len(fl.assignments) == 1
                        and fl.assignments[0].worker in self._stragglers):
                    w = self._pick_worker(
                        exclude=self._stragglers
                        | {fl.assignments[0].worker})
                    if w is not None:
                        fl.req.hedged = True
                        fl.hedge_workers.add(w)
                        self._counters["hedges"].inc()
                        self.tracer.instant(
                            fl.req.uid, "hedge", tick, worker=w,
                            straggler=fl.assignments[0].worker)
                        self._assign(fl, w)

    def _timeouts(self, tick: int) -> None:
        for fl in list(self._flights.values()):
            req = fl.req
            svc = req.service
            if (svc.deadline is not None
                    and tick - req.admit_tick > svc.deadline):
                self._fail(fl, "deadline")
                continue
            if not fl.assignments:
                self._replay(fl, exclude=set())
                continue
            for asg in list(fl.assignments):
                if tick - asg.last_progress <= svc.retry_timeout:
                    continue
                if asg.resends < svc.max_retries \
                        and self._alive(asg.worker):
                    # silent loss (dropped chunk, delayed ack): resend
                    # the outstanding message — idempotent on the worker
                    asg.resends += 1
                    req.retries += 1
                    self._counters["resends"].inc()
                    self._counters["retries_timeout"].inc()
                    self.tracer.instant(req.uid, "retry", tick,
                                        cause="timeout",
                                        worker=asg.worker)
                    asg.last_progress = tick
                    if asg.solving:
                        asg.solving = False
                    self._send_next(fl, asg)
                else:
                    # this worker copy is beyond saving: replay elsewhere
                    bad = asg.worker
                    self._drop_assignment(fl, asg)
                    if not fl.assignments:
                        if req.replays <= svc.max_retries:
                            self._replay(fl, exclude={bad})
                        else:
                            self._fail(fl, "retries-exhausted")

    def run(self, max_ticks: int = 100_000) -> None:
        """Drive the virtual clock until every admitted request settles."""
        for _ in range(max_ticks):
            if not self.pending:
                return
            self.step()
        if self.pending:
            raise RuntimeError(f"{self.pending} requests still pending "
                               f"after {max_ticks} ticks")

    # ------------------------------------------------------------- metrics
    def latency_quantiles(self) -> dict:
        """p50/p99 of completed-request latency, read from the streaming
        histogram sketch: available mid-run, identical at every call site
        (``launch.serve`` prints exactly this), no sample retention."""
        return {"p50": self._lat.quantile(0.5),
                "p99": self._lat.quantile(0.99)}

    def close(self) -> None:
        """Stop the pump threads (``parallel_pump``); the fleet can still
        be read, not stepped in parallel."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def snapshot(self) -> dict:
        """One deterministic observability snapshot: tick, every metric
        (counters / gauges+hwm / histogram sketches), and the SLO board's
        per-monitor report (fitted level, slope, breach ETA)."""
        return {"tick": self.tick,
                "metrics": self.metrics.snapshot(),
                "slo": self.slo.report(self.tick)}
