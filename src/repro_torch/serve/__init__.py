"""Serving engines: continuous batching over fixed slot pools and the
fault-tolerant fleet (port of ``repro.serve``).

``fit_engine`` serves the paper's workload, matricized LSE curve fits, in
one process; ``fleet`` puts replicated fit workers behind a dispatcher
that survives crashes, stragglers, lost and corrupt messages; ``engine``
is the token-decode engine over the model zoo.
"""
from repro_torch.serve.engine import ServeEngine, EngineConfig, Request
from repro_torch.serve.fit_engine import (FitServeEngine, FitServeConfig,
                                          FitRequest)
from repro_torch.serve.fleet import (FitFleet, FleetConfig, FleetRequest,
                                     FleetWorker)
from repro_torch.serve.sampling import sample

__all__ = ["ServeEngine", "EngineConfig", "Request",
           "FitServeEngine", "FitServeConfig", "FitRequest",
           "FitFleet", "FleetConfig", "FleetRequest", "FleetWorker",
           "sample"]
