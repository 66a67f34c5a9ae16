"""Core matricized LSE curve fitting (PyTorch port).  Public re-exports of
what the port holds so far."""
from repro_torch.core.basis import (Domain, vandermonde, evaluate, MONOMIAL,
                                    CHEBYSHEV)
from repro_torch.core.moments import (Moments, gram_moments,
                                      gram_moments_blocked, power_sums,
                                      hankel_from_power_sums, moment_vector,
                                      decay_ladder)
from repro_torch.core.solve import (gaussian_elimination, cholesky_solve,
                                    qr_solve_vandermonde, qr_solve_gram,
                                    svd_solve, condition_estimate,
                                    select_solver, solve_with_fallback,
                                    cond_cap_for, SOLVERS)
from repro_torch.core.solve import solve as solve_linear
from repro_torch.core.fit import (Polynomial, FitReport, StreamedFitReport,
                                  FitDiagnostics, polyfit, polyfit_qr,
                                  fit_from_moments, fit_report,
                                  fit_report_streamed, sse_from_moments,
                                  report_from_moments)
from repro_torch.core.robust import robust_polyfit, RobustFit, HUBER, TUKEY
from repro_torch.core.lspia import lspia_fit, LSPIAFit
from repro_torch.core.distributed import (make_distributed_fit,
                                          make_distributed_select,
                                          local_moments, psum_moments)
from repro_torch.core.streaming import (StreamState, update, current_fit,
                                        current_sse)
from repro_torch.core.scaling_laws import PowerLaw, fit_power_law

# repro_torch.select builds on these modules, so its names are re-exported
# lazily: an eager import here would be circular
_SELECT_EXPORTS = ("select_degree", "DegreeSearch", "Selection",
                   "SweepResult", "sweep_from_moments")


def __getattr__(name):
    if name in _SELECT_EXPORTS:
        import repro_torch.select as _select
        return getattr(_select, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Domain", "vandermonde", "evaluate", "MONOMIAL", "CHEBYSHEV",
    "Moments", "gram_moments", "gram_moments_blocked", "power_sums",
    "hankel_from_power_sums", "moment_vector", "decay_ladder",
    "gaussian_elimination", "cholesky_solve", "qr_solve_vandermonde",
    "qr_solve_gram", "svd_solve", "condition_estimate", "select_solver",
    "solve_with_fallback", "cond_cap_for", "SOLVERS", "solve_linear",
    "Polynomial", "FitReport", "StreamedFitReport", "FitDiagnostics",
    "polyfit", "polyfit_qr", "fit_from_moments", "fit_report",
    "fit_report_streamed", "sse_from_moments", "report_from_moments",
    "robust_polyfit", "RobustFit", "HUBER", "TUKEY",
    "lspia_fit", "LSPIAFit",
    "make_distributed_fit", "make_distributed_select",
    "local_moments", "psum_moments",
    "StreamState", "update", "current_fit", "current_sse",
    "PowerLaw", "fit_power_law",
    "select_degree", "DegreeSearch", "Selection", "SweepResult",
    "sweep_from_moments",
]
