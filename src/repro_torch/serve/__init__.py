"""Serving engines: continuous batching over fixed slot pools and the
fault-tolerant fleet (port of ``repro.serve``).

``fit_engine`` serves the paper's workload, matricized LSE curve fits, in
one process; ``fleet`` puts replicated fit workers behind a dispatcher
that survives crashes, stragglers, lost and corrupt messages.  The
token-decode engine is not ported yet.
"""
from repro_torch.serve.fit_engine import (FitServeEngine, FitServeConfig,
                                          FitRequest)
from repro_torch.serve.fleet import FitFleet, FleetConfig, FleetWorker

__all__ = ["FitServeEngine", "FitServeConfig", "FitRequest", "FitFleet",
           "FleetConfig", "FleetWorker"]
