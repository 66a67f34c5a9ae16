"""Fit-engine dispatch: one place decides how a fit executes.

``plan_fit`` inspects the problem (shape, dtype, degree, basis, device)
and returns a ``FitPlan`` that ``compute_moments`` /
``compute_report_sums`` execute."""
from repro_torch.engine.plan import (FitPlan, NumericsPolicy, plan_fit,
                                     compute_moments, compute_report_sums,
                                     resolve_engine, resolve_numerics,
                                     reset_moment_counter, moment_counter,
                                     record_collective,
                                     reset_collective_counter,
                                     collective_counter,
                                     REFERENCE, KERNEL_PLAIN, KERNEL_PACKED,
                                     PATHS, ENGINES, SOLVERS,
                                     PACKED_MIN_BATCH, KERNEL_MIN_POINTS,
                                     AUTO_NORMALIZE_DEGREE_F32,
                                     AUTO_NORMALIZE_DEGREE_F64)

__all__ = [
    "FitPlan", "NumericsPolicy", "plan_fit",
    "compute_moments", "compute_report_sums",
    "resolve_engine", "resolve_numerics", "reset_moment_counter",
    "moment_counter",
    "record_collective", "reset_collective_counter", "collective_counter",
    "REFERENCE", "KERNEL_PLAIN", "KERNEL_PACKED", "PATHS", "ENGINES",
    "SOLVERS", "PACKED_MIN_BATCH", "KERNEL_MIN_POINTS",
    "AUTO_NORMALIZE_DEGREE_F32", "AUTO_NORMALIZE_DEGREE_F64",
]
