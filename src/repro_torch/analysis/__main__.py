"""``python -m repro_torch.analysis`` — lint the port against its own
invariants (the flags and exit codes of ``python -m repro.analysis``).

Exit status: 0 when no unsuppressed findings, 1 otherwise (2 on usage
errors).  Suppressed findings are reported (human mode) / recorded (JSON)
but do not fail the run — the audit trail stays visible either way.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.core import ALL_CODES, Report, run_lint


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint: AST checks for the port's step-key/"
                    "host-sync/replay/protocol/dtype/shared-memory "
                    "invariants")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: "
                         "src/repro_torch, examples/torch_*.py and "
                         "chip_smoke.py)")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--select", default="",
                    help="comma-separated finding codes to run "
                         f"(known: {', '.join(sorted(ALL_CODES))})")
    ap.add_argument("--output", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the finding-code table and exit")
    args = ap.parse_args(argv)

    if args.list_codes:
        for code in sorted(ALL_CODES):
            print(f"{code:15s} {ALL_CODES[code]}")
        return 0

    select = tuple(c.strip() for c in args.select.split(",") if c.strip())
    unknown = [c for c in select if c not in ALL_CODES]
    if unknown:
        print(f"unknown code(s) {unknown}; known: {sorted(ALL_CODES)}",
              file=sys.stderr)
        return 2

    report: Report = run_lint(args.paths or None, select=select or None)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report.to_json() + "\n")
    if args.format == "json":
        print(report.to_json())
    else:
        print(report.render_human())
    return 1 if report.unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
