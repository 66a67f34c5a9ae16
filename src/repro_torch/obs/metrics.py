"""Metrics registry: counters, gauges, and mergeable quantile sketches
(a copy of ``repro.obs.metrics``: framework-free Python, kept here so the
port imports nothing of the reference package).

The serving stack (``serve.fit_engine``) and the streaming ingestors
record through this one registry:

* ``Counter`` / ``Gauge`` — monotone event counts and level samples; the
  gauge keeps a high-water mark so "peak queue depth" is a first-class
  readable, not a post-hoc scan.
* ``HistogramSketch`` — a DDSketch-style log-bucketed streaming quantile
  sketch (arXiv:1908.10693's scheme in miniature): bucket ``i`` holds all
  values in ``(gamma^(i-1), gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``,
  so any quantile is answered to relative error ``alpha`` from O(log range)
  integer counts — **no sample retention**, O(1) amortised per observe, and
  two sketches over the same ``alpha`` merge by bucket-count addition, which
  makes merge associative and commutative *by construction* (tested under
  hypothesis in ``tests/test_obs.py``).
* ``MetricsRegistry`` — get-or-create by name, deterministic ``snapshot()``
  (sorted keys, plain python scalars — snapshot equality is run equality),
  and Prometheus-style text exposition for scraping / eyeballing.
* ``NullRegistry`` / ``NULL_REGISTRY`` — the no-op twin.  Instrumented code
  takes a registry object and calls it unconditionally; handing it the null
  twin makes the whole layer a few empty method calls (the ``obs_overhead``
  bench row gates this at <= 5% of the serve path).

Everything here is host-side python over python ints/floats: none of it
touches a tensor.
"""
from __future__ import annotations

import json
import math


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Level sample with a high-water mark (peak value ever set)."""

    __slots__ = ("name", "_value", "_hwm")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._hwm = 0.0

    def set(self, v: float) -> None:
        v = float(v)
        self._value = v
        if v > self._hwm:
            self._hwm = v

    @property
    def value(self) -> float:
        return self._value

    @property
    def hwm(self) -> float:
        return self._hwm


class HistogramSketch:
    """Log-bucketed streaming quantile sketch (DDSketch scheme).

    ``observe(x)`` increments the count of bucket ``ceil(log_gamma(x))``;
    non-positive values land in a dedicated zero bucket.  ``quantile(q)``
    walks the cumulative counts and returns the bucket midpoint
    ``2·gamma^i / (gamma+1)``, whose relative error against any value in
    the bucket is at most ``alpha``.  ``merge`` adds bucket counts —
    exact, order-independent, associative.
    """

    __slots__ = ("name", "alpha", "gamma", "_inv_lg", "buckets",
                 "zero_count", "count", "total", "min", "max")

    def __init__(self, name: str, alpha: float = 0.01):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must lie in (0, 1), got {alpha}")
        self.name = name
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._inv_lg = 1.0 / math.log(self.gamma)
        self.buckets: dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float, n: int = 1) -> None:
        x = float(x)
        self.count += n
        self.total += x * n
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x <= 0.0:
            self.zero_count += n
            return
        i = math.ceil(math.log(x) * self._inv_lg)
        self.buckets[i] = self.buckets.get(i, 0) + n

    def _bucket_value(self, i: int) -> float:
        return 2.0 * self.gamma ** i / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], to relative error ``alpha``."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = q * (self.count - 1)       # 0-indexed rank to reach
        if rank < self.zero_count:
            return 0.0
        cum = self.zero_count
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum > rank:
                return self._bucket_value(i)
        return self._bucket_value(max(self.buckets))

    def quantiles(self, qs=(0.5, 0.99)) -> dict:
        return {f"p{round(q * 100):d}": self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        """Return a new sketch holding both streams (same ``alpha``)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(f"cannot merge sketches with alpha="
                             f"{self.alpha} and {other.alpha}")
        out = HistogramSketch(self.name, self.alpha)
        out.buckets = dict(self.buckets)
        for i, n in other.buckets.items():
            out.buckets[i] = out.buckets.get(i, 0) + n
        out.zero_count = self.zero_count + other.zero_count
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def snapshot(self) -> dict:
        return {"alpha": self.alpha, "count": self.count,
                "zero_count": self.zero_count, "total": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "buckets": {str(i): n
                            for i, n in sorted(self.buckets.items())}}

    @classmethod
    def from_snapshot(cls, name: str, snap: dict) -> "HistogramSketch":
        h = cls(name, snap["alpha"])
        h.count = int(snap["count"])
        h.zero_count = int(snap["zero_count"])
        h.total = float(snap["total"])
        h.min = float(snap["min"]) if h.count else math.inf
        h.max = float(snap["max"]) if h.count else -math.inf
        h.buckets = {int(i): int(n) for i, n in snap["buckets"].items()}
        return h


class MetricsRegistry:
    """Named get-or-create metric store with deterministic snapshots."""

    enabled = True

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, HistogramSketch] = {}

    # ------------------------------------------------------ get-or-create
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, alpha: float = 0.01) -> HistogramSketch:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = HistogramSketch(name, alpha)
        return h

    # ----------------------------------------------------------- readouts
    def counters(self) -> dict:
        return {n: c.value for n, c in sorted(self._counters.items())}

    def snapshot(self) -> dict:
        """Plain-scalar nested dict, keys sorted: two runs produced the
        same snapshot iff they took the same instrumented path."""
        return {
            "counters": self.counters(),
            "gauges": {n: {"value": g.value, "hwm": g.hwm}
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._hists.items())},
        }

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges + ``_hwm``,
        histograms as summaries with p50/p90/p99 quantile samples)."""
        lines: list[str] = []
        for n, c in sorted(self._counters.items()):
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {c.value}")
        for n, g in sorted(self._gauges.items()):
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {g.value:g}")
            lines.append(f"{n}_hwm {g.hwm:g}")
        for n, h in sorted(self._hists.items()):
            lines.append(f"# TYPE {n} summary")
            for q in (0.5, 0.9, 0.99):
                lines.append(f'{n}{{quantile="{q:g}"}} '
                             f"{h.quantile(q):g}")
            lines.append(f"{n}_sum {h.total:g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------ no-op twins


class _NullCounter:
    __slots__ = ()
    name = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = ""
    value = 0.0
    hwm = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = ""
    alpha = 0.01
    count = 0
    total = 0.0
    mean = 0.0

    def observe(self, x: float, n: int = 1) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def quantiles(self, qs=(0.5, 0.99)) -> dict:
        return {f"p{round(q * 100):d}": 0.0 for q in qs}

    def snapshot(self) -> dict:
        return {}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HIST = _NullHistogram()


class NullRegistry:
    """The disabled recorder: every lookup returns a shared no-op metric.
    Instrumented code never branches on "is obs on?" — it just records,
    and recording into this registry is a few empty method calls."""

    enabled = False

    def counter(self, name: str) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str, alpha: float = 0.01) -> _NullHistogram:
        return _NULL_HIST

    def counters(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def render_prometheus(self) -> str:
        return "\n"


NULL_REGISTRY = NullRegistry()
