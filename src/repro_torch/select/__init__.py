"""Automatic model selection from a single data pass (port of
``repro.select``).

The degree-M moment state nests every lower degree (``Moments.truncate``),
so one accumulation carries the whole ladder d = 0..M: per-degree
condition-aware solves, moment-space information criteria, and k-fold
cross-validation by fold subtraction, with no refits and no extra passes.

Entry points: ``select_degree(x, y, max_degree=...)``;
``core.polyfit(..., degree="auto" | DegreeSearch(...))``;
``api.FitSpec(degree=DegreeSearch(...))``; ``sweep_from_moments`` /
``solve_ladder`` from an existing state.
"""
from repro_torch.select.criteria import (ScoreTable, score_table,
                                         best_degree, CRITERIA,
                                         MOMENT_CRITERIA)
from repro_torch.select.sweep import (SweepResult, DegreeSearch, Selection,
                                      solve_ladder, sweep_from_moments,
                                      selection_from_sweep, select_degree)
from repro_torch.select.crossval import (fold_moments, sum_folds,
                                         complement_moments, cv_scores)

__all__ = [
    "ScoreTable", "score_table", "best_degree", "CRITERIA",
    "MOMENT_CRITERIA",
    "SweepResult", "DegreeSearch", "Selection", "solve_ladder",
    "sweep_from_moments", "selection_from_sweep", "select_degree",
    "fold_moments", "sum_folds", "complement_moments", "cv_scores",
]
