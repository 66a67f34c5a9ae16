"""reprolint for the PyTorch port: repo-aware static analysis + runtime
sanitizers (port of ``repro.analysis``; imports no JAX).

Run ``python -m repro_torch.analysis`` (or see README, the port's
section)."""
from repro_torch.analysis.core import (ALL_CODES, CODE_SUPPRESS,
                                       DEFAULT_ROOTS, SCHEMA_VERSION,
                                       Checker, FileContext, Finding, Report,
                                       Suppression, default_checkers,
                                       default_roots, discover_files,
                                       fixture_scope_path, lint_file,
                                       run_lint)
from repro_torch.analysis.sanitizers import (CompileCounter, NaNOriginError,
                                             assert_no_recompiles,
                                             nan_origin)

__all__ = [
    "ALL_CODES", "CODE_SUPPRESS", "DEFAULT_ROOTS", "SCHEMA_VERSION",
    "Checker", "FileContext", "Finding", "Report", "Suppression",
    "default_checkers", "default_roots", "discover_files",
    "fixture_scope_path", "lint_file", "run_lint",
    "CompileCounter", "NaNOriginError", "assert_no_recompiles",
    "nan_origin",
]
