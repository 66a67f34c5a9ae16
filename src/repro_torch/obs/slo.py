"""SLO monitors that dogfood the paper's own streaming fit stack (port of
``repro.obs.slo``).

The thesis of the repo is that matricized LSE moments make curve fitting
O(1)-state and streamable (arXiv:1512.08017).  This module turns that
machinery on the serving stack itself: each watched metric (fleet p99
latency, queue depth, staleness lag, ...) feeds a decayed ``StreamState``
polynomial fit of metric-vs-tick — exactly the ``train.monitors``
LossCurveMonitor pattern — and the fitted curve answers the two questions
a pager cares about *online*:

* **is the trend regressing?** — the fitted slope at the current tick;
* **when does it breach?** — ``breach_eta`` extrapolates the fitted curve
  forward and returns the first tick at which it crosses the SLO
  threshold (coarse scan + fine refinement, same scheme as
  ``LossCurveMonitor.eta_to``), i.e. a forecast *before* the raw metric
  itself crosses.

``SLOBoard`` wires monitors to a ``MetricsRegistry``: a metric reference
is ``"latency_ticks:p99"`` (histogram quantile), ``"queue_depth"`` /
``"queue_depth:hwm"`` (gauge), or a counter name; ``update(tick)``
resolves each reference against the live registry and folds one
observation per monitor.  All fits run on tiny (degree+1)² moment states
— the observability layer costs what one more fit costs.
"""
from __future__ import annotations

import dataclasses

from typing import Any

import numpy as np
import torch

from repro_torch.core import streaming


@dataclasses.dataclass
class SLOMonitor:
    """One metric's trend: a decayed moment-space polynomial fit of
    (tick, value), plus threshold crossing forecast.  The running state
    lives on ``device`` (``None`` means CUDA)."""

    metric: str
    threshold: float
    degree: int = 1
    decay: float = 0.98
    ridge: float = 1e-6
    horizon: int = 4096            # ticks searched for a breach crossing
    tick_scale: float = 256.0      # ticks scaled to keep Gram conditioned
    device: Any = None

    def __post_init__(self):
        self._state = streaming.StreamState.create(
            self.degree, decay=self.decay, dtype=torch.float32,
            device=self.device)
        self._n = 0
        self.last_value: float | None = None
        self.last_tick: int = -1

    def observe(self, tick: int, value: float) -> None:
        dev = self._state.device
        x = torch.tensor([tick / self.tick_scale], dtype=torch.float32,
                         device=dev)
        y = torch.tensor([float(value)], dtype=torch.float32, device=dev)
        self._state = streaming.update(self._state, x, y)
        self._n += 1
        self.last_value = float(value)
        self.last_tick = int(tick)

    @property
    def ready(self) -> bool:
        return self._n >= self.degree + 2

    def _coeffs(self) -> np.ndarray:
        poly = streaming.current_fit(self._state, ridge=self.ridge)
        return poly.coeffs.detach().cpu().double().numpy()

    def level(self, tick: int) -> float:
        """Fitted metric level at ``tick`` (denoised current value)."""
        c = self._coeffs()
        t = tick / self.tick_scale
        return float(np.polyval(c[::-1], t))

    def slope(self, tick: int) -> float:
        """d(metric)/d(tick) of the fitted trend at ``tick``."""
        c = self._coeffs()
        t = tick / self.tick_scale
        ks = np.arange(1, len(c))
        return float(np.sum(ks * c[1:] * t ** (ks - 1)) / self.tick_scale)

    def breach_eta(self, tick: int) -> int | None:
        """Ticks until the fitted curve crosses ``threshold`` (0 if the
        fitted level is already past it; None if no crossing within
        ``horizon`` ticks).  Coarse scan + fine refinement inside the
        first crossing bucket — robust for any fit degree."""
        if not self.ready:
            return None
        c = self._coeffs()

        def first_hit(lo: float, hi: float, n: int) -> float | None:
            ts = np.linspace(lo, hi, n)
            vals = np.polyval(c[::-1], ts / self.tick_scale)
            hit = np.nonzero(vals >= self.threshold)[0]
            return float(ts[hit[0]]) if hit.size else None

        coarse = first_hit(tick, tick + self.horizon, 1024)
        if coarse is None:
            return None
        bucket = max(1.0, self.horizon / 1024)
        fine = first_hit(max(tick, coarse - bucket), coarse, 64)
        at = fine if fine is not None else coarse
        return max(0, int(round(at - tick)))

    def report(self, tick: int) -> dict:
        eta = self.breach_eta(tick) if self.ready else None
        return {
            "metric": self.metric,
            "threshold": self.threshold,
            "value": self.last_value,
            "fitted": self.level(tick) if self.ready else None,
            "slope": self.slope(tick) if self.ready else None,
            "breach_eta_ticks": eta,
            "breached": bool(self.last_value is not None
                             and self.last_value >= self.threshold),
            "observations": self._n,
        }


def resolve_metric(registry, ref: str) -> float | None:
    """Resolve a metric reference against a ``MetricsRegistry``.

    ``"name:pNN"`` — histogram quantile (None while the sketch is empty);
    ``"name:hwm"`` — gauge high-water mark; ``"name:mean"`` — histogram
    mean; bare ``"name"`` — gauge value if one exists under that name,
    else counter value."""
    if ":" in ref:
        base, stat = ref.rsplit(":", 1)
        if stat == "hwm":
            return float(registry.gauge(base).hwm)
        h = registry.histogram(base)
        if h.count == 0:
            return None
        if stat == "mean":
            return float(h.mean)
        if stat.startswith("p"):
            return float(h.quantile(int(stat[1:]) / 100.0))
        raise ValueError(f"unknown metric stat {stat!r} in {ref!r}")
    gauges = getattr(registry, "_gauges", {})
    if ref in gauges:
        return float(gauges[ref].value)
    return float(registry.counter(ref).value)


class SLOBoard:
    """A set of SLO monitors fed from one live metrics registry; their
    states live on ``device`` (``None`` means CUDA)."""

    def __init__(self, registry, device=None):
        self.registry = registry
        self.device = device
        self.monitors: dict[str, SLOMonitor] = {}

    def watch(self, ref: str, threshold: float, **kw) -> SLOMonitor:
        kw.setdefault("device", self.device)
        mon = SLOMonitor(metric=ref, threshold=threshold, **kw)
        self.monitors[ref] = mon
        return mon

    def update(self, tick: int) -> None:
        """Fold one observation per monitor from the live registry
        (metrics with no data yet are skipped, not zero-filled)."""
        for ref, mon in self.monitors.items():
            v = resolve_metric(self.registry, ref)
            if v is not None:
                mon.observe(tick, v)

    def report(self, tick: int) -> dict:
        return {ref: mon.report(tick)
                for ref, mon in sorted(self.monitors.items())}

    def breaching(self, tick: int, within: int) -> list[str]:
        """Metric refs whose forecast crossing lands within ``within``
        ticks (includes already-breached monitors at eta 0)."""
        out = []
        for ref, mon in sorted(self.monitors.items()):
            eta = mon.breach_eta(tick)
            if eta is not None and eta <= within:
                out.append(ref)
        return out


class NullBoard:
    """Disabled twin for the off-path."""

    monitors: dict = {}

    def watch(self, ref, threshold, **kw):
        return None

    def update(self, tick) -> None:
        pass

    def report(self, tick) -> dict:
        return {}

    def breaching(self, tick, within) -> list:
        return []


NULL_BOARD = NullBoard()
