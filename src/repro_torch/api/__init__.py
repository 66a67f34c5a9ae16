"""``repro_torch.api`` — one declarative FitSpec, its executors.

>>> from repro_torch import api
>>> api.fit(x, y, api.FitSpec(degree=3)).poly      # on CUDA
>>> api.fit(x, y, api.FitSpec(degree=3), device="cpu")
>>> st = api.FitSpec(degree=3).streaming(); ...    # O(1)-state streaming
>>> run = spec.distributed(mesh); run(x_block, y_block)  # a rank's block
>>> serve_engine.submit(x, y, spec=spec)           # the fit server
>>> fleet.submit(x, y, spec=spec, service=api.ServicePolicy(deadline=50))
"""
from repro_torch.api.spec import (FitSpec, FitResult, IRLSOptions,
                                  LSPIAOptions, METHODS, RAW_DATA_SOLVERS,
                                  ServicePolicy)
from repro_torch.api.executors import (fit, spec_from_legacy,
                                       stream_state, stream_result,
                                       make_distributed)
from repro_torch.engine.plan import NumericsPolicy
from repro_torch.select.sweep import DegreeSearch

__all__ = [
    "FitSpec", "FitResult", "IRLSOptions", "LSPIAOptions", "METHODS",
    "RAW_DATA_SOLVERS", "ServicePolicy", "fit", "spec_from_legacy", "stream_state",
    "stream_result", "make_distributed", "NumericsPolicy",
    "DegreeSearch",
]
