"""Runtime observability for every fit surface: metrics, traces, SLOs
(port of ``repro.obs``).

``Observability`` bundles the three recorders the serving stack takes as
one injectable handle.  ``Observability.off()`` (the default everywhere)
is the no-op twin — instrumented code records unconditionally and the
null recorders make that a few empty method calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.obs.metrics import (Counter, Gauge, HistogramSketch,
                                     MetricsRegistry, NullRegistry,
                                     NULL_REGISTRY)
from repro_torch.obs.trace import (Tracer, NullTracer, NULL_TRACER,
                                   FLEET_UID, parse_jsonl, validate_events,
                                   assert_valid)
from repro_torch.obs.slo import (SLOMonitor, SLOBoard, NullBoard,
                                 NULL_BOARD, resolve_metric)


@dataclasses.dataclass
class Observability:
    """One injectable handle: metrics registry + tracer + SLO board."""

    metrics: Any = dataclasses.field(default_factory=MetricsRegistry)
    tracer: Any = NULL_TRACER
    slo: Any = NULL_BOARD
    enabled: bool = True

    @staticmethod
    def on(*, trace: bool = True, device=None) -> "Observability":
        """Everything on; the SLO board's fits live on ``device``
        (``None`` means CUDA)."""
        reg = MetricsRegistry()
        return Observability(metrics=reg,
                             tracer=Tracer() if trace else NULL_TRACER,
                             slo=SLOBoard(reg, device=device), enabled=True)

    @staticmethod
    def off() -> "Observability":
        return NULL_OBS


NULL_OBS = Observability(metrics=NULL_REGISTRY, tracer=NULL_TRACER,
                         slo=NULL_BOARD, enabled=False)

__all__ = [
    "Observability", "NULL_OBS",
    "Counter", "Gauge", "HistogramSketch", "MetricsRegistry",
    "NullRegistry", "NULL_REGISTRY",
    "Tracer", "NullTracer", "NULL_TRACER", "FLEET_UID",
    "parse_jsonl", "validate_events", "assert_valid",
    "SLOMonitor", "SLOBoard", "NullBoard", "NULL_BOARD", "resolve_metric",
]
