"""Deterministic, seedable fault injection for the serving fleet (port of
``repro.runtime.chaos``, kept as its own copy: numpy only, and the same
seed draws the same events in the same order as the reference).

Robustness has to be *tested in*, not assumed (Skala, arXiv:1802.07591
catalogs how LSE degrades silently under adverse inputs): this module
turns "what if a worker dies mid-ingest" into a reproducible unit test.
A ``ChaosSchedule`` is a list of ``FaultEvent``s pinned to virtual ticks
— written explicitly by a test, or generated from one integer seed — and
``ChaosWorker`` wraps any fleet worker (anything with ``.process(msg,
tick)``) to realize them:

  * ``crash``  — the worker dies (stops heartbeating, loses all state)
                 until the dispatcher's restart policy revives it;
  * ``stall``  — the worker stays alive (heartbeats) but processes
                 nothing for ``duration`` ticks: a straggler;
  * ``drop``   — the next ingest message delivered to the worker
                 vanishes (network loss; the dispatcher must retry);
  * ``delay``  — the worker's next replies are delivered ``duration``
                 ticks late (retries may race the late ack — the
                 journal's idempotence is what keeps that safe);
  * ``poison`` — the worker's next result reply has its coefficients
                 replaced with NaN (the silent-corruption case the
                 dispatcher's result validation must quarantine).

Everything is keyed on the fleet's injected virtual clock — no
wall-clock sleeps anywhere — so the same seed + schedule reproduces the
same fault interleaving on every run, which is what lets the chaos
parity invariant (faulted run == fault-free run) be a committed test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("crash", "stall", "drop", "delay", "poison")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault, armed at ``tick`` against ``worker``.

    ``duration`` is the stall length / reply delay in ticks (ignored by
    the one-shot kinds)."""

    tick: int
    worker: int
    kind: str
    duration: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind={self.kind!r}; expected one of "
                             f"{FAULT_KINDS}")
        if self.tick < 0 or self.duration < 0:
            raise ValueError(f"tick/duration must be >= 0, got "
                             f"{self.tick}/{self.duration}")


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """An immutable, sorted fault schedule over a worker fleet."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events,
                                        key=lambda e: (e.tick, e.worker))))

    def for_worker(self, worker: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.worker == worker)

    @staticmethod
    def from_seed(seed: int, n_workers: int, horizon: int, *,
                  crashes: int = 0, stalls: int = 0, drops: int = 0,
                  delays: int = 0, poisons: int = 0,
                  stall_ticks: int = 50,
                  delay_ticks: int = 6) -> "ChaosSchedule":
        """Generate a schedule from one integer seed (deterministic: the
        same arguments always produce the same events, in the same fixed
        draw order).  Counts are per-kind totals over ``horizon`` ticks;
        crash targets are drawn without replacement so a single chaos run
        never kills the whole fleet unless asked to."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        crash_workers = rng.choice(n_workers, size=min(crashes, n_workers),
                                   replace=False)
        for w in crash_workers:
            events.append(FaultEvent(int(rng.integers(1, horizon)),
                                     int(w), "crash"))
        for kind, count, dur in (("stall", stalls, stall_ticks),
                                 ("drop", drops, 0),
                                 ("delay", delays, delay_ticks),
                                 ("poison", poisons, 0)):
            for _ in range(count):
                events.append(FaultEvent(int(rng.integers(1, horizon)),
                                         int(rng.integers(n_workers)),
                                         kind, dur))
        return ChaosSchedule(tuple(events))

    @staticmethod
    def parse(spec: str, seed: int, n_workers: int,
              horizon: int = 64) -> "ChaosSchedule":
        """Parse the CLI spelling ``"crash=1,stall=1,poison=2"`` into a
        seeded schedule (``launch.serve --chaos``)."""
        counts = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            kind, _, n = part.partition("=")
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in "
                                 f"--chaos {spec!r}; expected "
                                 f"{FAULT_KINDS}")
            counts[kind] = int(n or 1)
        return ChaosSchedule.from_seed(
            seed, n_workers, horizon,
            crashes=counts.get("crash", 0), stalls=counts.get("stall", 0),
            drops=counts.get("drop", 0), delays=counts.get("delay", 0),
            poisons=counts.get("poison", 0))


class ChaosWorker:
    """Wrap any worker in a fault schedule.

    The wrapped object only needs the fleet worker protocol —
    ``process(msg, tick) -> list[reply]`` and ``reset()`` — and messages /
    replies only need a ``.kind`` attribute ("ingest" / "result" / ...),
    so the injector is reusable against anything mailbox-shaped.  The
    dispatcher drives it with ``begin_tick`` (arm due faults), checks
    ``alive`` / ``stalled`` before pumping, and receives each reply as a
    ``(delay_ticks, reply)`` pair.
    """

    def __init__(self, inner, worker_id: int,
                 events: tuple[FaultEvent, ...] = ()):
        self.inner = inner
        self.worker_id = worker_id
        self._pending = sorted(events, key=lambda e: e.tick)
        self.alive = True
        self.stalled_until = -1
        self._drop_next = 0
        self._delay_next = 0      # ticks to delay the next replies by
        self._poison_next = 0
        self.faults_applied: list[FaultEvent] = []

    # ------------------------------------------------------------- schedule
    def begin_tick(self, tick: int) -> None:
        """Arm every fault whose tick has arrived."""
        while self._pending and self._pending[0].tick <= tick:
            ev = self._pending.pop(0)
            self.faults_applied.append(ev)
            if ev.kind == "crash":
                self.alive = False
                self.inner.reset()     # a dead worker loses its state
            elif ev.kind == "stall":
                self.stalled_until = max(self.stalled_until,
                                         tick + ev.duration)
            elif ev.kind == "drop":
                self._drop_next += 1
            elif ev.kind == "delay":
                self._delay_next = max(self._delay_next, ev.duration)
            elif ev.kind == "poison":
                self._poison_next += 1

    def stalled(self, tick: int) -> bool:
        return tick <= self.stalled_until

    def revive(self) -> None:
        """Restart after a crash: fresh state, future faults still armed."""
        self.inner.reset()
        self.alive = True

    # ------------------------------------------------------------- mailbox
    def process(self, msg, tick: int) -> list[tuple[int, object]]:
        """Run one message through the inner worker, applying drop /
        delay / poison faults on the way; returns (delay, reply) pairs."""
        if not self.alive:
            return []
        if self._drop_next and getattr(msg, "kind", None) == "ingest":
            self._drop_next -= 1
            return []
        replies = self.inner.process(msg, tick)
        out = []
        for rep in replies:
            if self._poison_next and getattr(rep, "kind", None) == "result":
                self._poison_next -= 1
                rep = rep.poisoned()
            delay = self._delay_next
            out.append((delay, rep))
        if replies:
            self._delay_next = 0
        return out
