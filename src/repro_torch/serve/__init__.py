"""Serving engines: continuous batching over fixed slot pools (port of
``repro.serve``).

``fit_engine`` serves the paper's workload, matricized LSE curve fits.
The fault-tolerant fleet and the token-decode engine are later slices.
"""
from repro_torch.serve.fit_engine import (FitServeEngine, FitServeConfig,
                                          FitRequest)

__all__ = ["FitServeEngine", "FitServeConfig", "FitRequest"]
