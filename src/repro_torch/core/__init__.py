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
]
