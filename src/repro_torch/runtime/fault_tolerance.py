"""Fault-tolerant runtime: heartbeats, failure detection, restart policy,
elastic rescale (port of ``repro.runtime.fault_tolerance``).  The control
plane is deliberately dependency-free (host callbacks) so it can sit on any
cluster scheduler; only the straggler fit touches a device, the one the
caller names.

What large-scale runs get from this module:
  * HeartbeatTracker  — per-host liveness with configurable timeout
  * FailureDetector   — combines missing heartbeats + straggler fits (the
                        paper's LSE on step-time series, runtime.straggler)
  * RestartPolicy     — bounded exponential backoff, max-restarts budget
  * ElasticPlan       — given surviving hosts, picks the largest valid mesh
                        (full data-parallel replicas only) and the checkpoint
                        step to resume from
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HeartbeatTracker:
    n_hosts: int
    timeout_s: float = 60.0

    def __post_init__(self):
        now = time.monotonic()
        self.last_seen = {h: now for h in range(self.n_hosts)}

    def beat(self, host: int, t: float | None = None) -> None:
        self.last_seen[host] = time.monotonic() if t is None else t

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]


@dataclasses.dataclass
class RestartPolicy:
    """Bounded restart budget with decorrelated-jitter backoff.

    ``jitter="decorrelated"`` (the default) draws each wait uniformly from
    ``[base, min(3 * previous_wait, max)]`` — the AWS decorrelated-jitter
    schedule — so a fleet of replicas that died together does NOT retry in
    lockstep (the thundering herd the plain exponential creates).  Every
    draw lies in ``[base_backoff_s, max_backoff_s]`` and the expected wait
    still grows geometrically until it saturates at the cap.  ``seed``
    makes the draw sequence reproducible (chaos tests pin it);
    ``jitter=None`` restores the deterministic exponential ladder."""

    max_restarts: int = 100
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0
    jitter: str | None = "decorrelated"
    seed: int | None = None

    restarts: int = 0

    def __post_init__(self):
        if self.jitter not in (None, "decorrelated"):
            raise ValueError(f"jitter={self.jitter!r}; expected "
                             "'decorrelated' or None")
        if not 0 < self.base_backoff_s <= self.max_backoff_s:
            raise ValueError(
                f"need 0 < base_backoff_s <= max_backoff_s, got "
                f"{self.base_backoff_s} / {self.max_backoff_s}")
        import numpy as np
        self._rng = np.random.default_rng(self.seed)
        self._prev = self.base_backoff_s

    def next_backoff(self) -> float | None:
        """None = give up."""
        if self.restarts >= self.max_restarts:
            return None
        self.restarts += 1
        if self.jitter is None:
            b = min(self.base_backoff_s * (2 ** min(self.restarts - 1, 10)),
                    self.max_backoff_s)
        else:
            hi = min(3.0 * self._prev, self.max_backoff_s)
            b = float(self._rng.uniform(self.base_backoff_s,
                                        max(self.base_backoff_s, hi)))
        self._prev = b
        return b


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_hosts: int          # surviving
    mesh_shape: tuple     # new mesh
    resume_step: int

    @staticmethod
    def plan(surviving_hosts: int, chips_per_host: int,
             model_parallel: int, resume_step: int) -> "ElasticPlan":
        """Largest mesh = (data, model) with model fixed (TP must fit the
        weights' sharding) and data = largest multiple that the surviving
        chips support. Data-parallel size may shrink/grow freely because the
        data pipeline keys examples by batch index, not host count, and the
        checkpoint restores with resharding."""
        chips = surviving_hosts * chips_per_host
        data = max(1, chips // model_parallel)
        return ElasticPlan(surviving_hosts, (data, model_parallel),
                           resume_step)


class FailureDetector:
    """Missing-heartbeat OR persistent-straggler (LSE-fitted) detection.

    The step-time fit lives on ``device`` (``None`` means CUDA)."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_threshold: float = 1.5, *, device=None):
        from repro_torch.train.monitors import StepTimeMonitor
        self.hb = HeartbeatTracker(n_hosts, timeout_s)
        self.steptime = StepTimeMonitor(n_hosts,
                                        threshold=straggler_threshold,
                                        device=device)
        self.n_hosts = n_hosts

    def observe_step(self, step: int, times_s, now: float | None = None):
        self.steptime.observe(step, times_s)
        for h in range(self.n_hosts):
            self.hb.beat(h, now)

    def verdict(self, step: int, now: float | None = None) -> dict:
        dead = self.hb.dead_hosts(now)
        slow = self.steptime.stragglers(step)
        return {"dead": dead, "stragglers": slow,
                "healthy": not dead and not slow}
