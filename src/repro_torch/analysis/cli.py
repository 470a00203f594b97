"""``repro-torch-lint`` — run the port's AST lint rules over source paths.

Usage::

    repro-torch-lint src/repro_torch [--error-on-findings] [--rules R1,R3]
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \
        --error-on-findings
    PYTHONPATH=src python -m repro_torch.analysis --list-rules

Exit codes: 0 clean, 1 findings reported under ``--error-on-findings``,
2 a file could not be parsed (or an unknown rule id).  Without
``--error-on-findings`` the tool only reports (exit 0), so exploratory runs
never break a shell pipeline. The lint reads source text only: it imports
nothing it checks and touches no device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Sequence

from .base import run_lint
from .rules import DEFAULT_RULES

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="repo-native static analysis for the PyTorch port")
    p.add_argument("paths", nargs="*", help="files or directories to lint")
    p.add_argument("--error-on-findings", action="store_true",
                   help="exit 1 if any finding is reported")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    return p


def main(argv: Sequence[str] | None = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    rules = list(DEFAULT_RULES)
    if args.list_rules:
        for r in rules:
            doc = (r.__doc__ or "").strip().splitlines()[0]
            print(f"{r.id}  {r.name:<24} {doc}")
        return 0
    if not args.paths:
        parser.error("the following arguments are required: paths")
    if args.rules:
        wanted = {s.strip() for s in args.rules.split(",")}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"repro-torch-lint: unknown rule id(s): {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]
    report = run_lint(args.paths, rules)
    for f in report.findings:
        print(f.render())
    for e in report.errors:
        print(f"repro-torch-lint: parse error: {e}", file=sys.stderr)
    n = len(report.findings)
    print(f"repro-torch-lint: {report.files_checked} files, {n} finding"
          f"{'' if n == 1 else 's'}")
    if report.errors:
        return 2
    if report.findings and args.error_on_findings:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
