"""repro-lint rule engine of the PyTorch port: findings, suppressions, and
the file walker (the port's own copy of ``repro/analysis/base.py``, which
is framework-free; the port imports nothing of the JAX package).

The engine is deliberately small: a :class:`Rule` owns a stable id
(``R1``..), a path scope (:meth:`Rule.applies`), and a :meth:`Rule.check`
that walks one parsed module and yields :class:`Finding`\\ s.
:func:`run_lint` parses each ``.py`` file once, runs every in-scope rule,
and filters findings through inline suppression comments.

Suppression syntax (the same comment form serves both packages)::

    x = y.item()  # repro-lint: disable=R1 -- host read outside the hot loop

A ``disable=`` comment silences the named rule(s) on its own line or, when
it stands alone, on the following line. The justification after ``--`` is
**mandatory**: a disable with no justification is itself reported as rule
``S0``, so the repo can never go clean by silencing rules silently.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Sequence

__all__ = ["Finding", "Rule", "Suppressions", "run_lint", "iter_py_files",
           "LintReport"]

_DISABLE_RE = re.compile(
    r"#\s*repro-lint:\s*disable=(?P<rules>[A-Za-z0-9, ]+?)"
    r"(?:\s*--\s*(?P<why>\S.*))?\s*$")


@dataclass(frozen=True)
class Finding:
    """One lint violation, pointing at a file:line."""
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class Rule:
    """Base class for repo-specific lint rules."""

    id: str = "R0"
    name: str = "unnamed"
    #: substrings of the posix path that put a file in scope; empty = all.
    scope: tuple[str, ...] = ()

    def applies(self, path: str) -> bool:
        posix = Path(path).as_posix()
        return not self.scope or any(s in posix for s in self.scope)

    def check(self, tree: ast.Module, src: str, path: str) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, path: str, line: int, message: str) -> Finding:
        return Finding(self.id, path, line, message)


class Suppressions:
    """Per-file map of line → rule ids disabled on that line."""

    def __init__(self, src: str, path: str):
        self.path = path
        self._by_line: dict[int, set[str]] = {}
        self.unjustified: list[Finding] = []
        for lineno, text in enumerate(src.splitlines(), start=1):
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
            if not m.group("why"):
                self.unjustified.append(Finding(
                    "S0", path, lineno,
                    "suppression without a justification — write "
                    "'# repro-lint: disable=<rule> -- <why>'"))
                continue
            # a standalone disable comment covers the next line too
            target = {lineno}
            if text.strip().startswith("#"):
                target.add(lineno + 1)
            for ln in target:
                self._by_line.setdefault(ln, set()).update(rules)

    def hides(self, finding: Finding) -> bool:
        return finding.rule in self._by_line.get(finding.line, ())


def iter_py_files(paths: Sequence[str | Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


@dataclass
class LintReport:
    findings: list[Finding] = field(default_factory=list)
    files_checked: int = 0
    errors: list[str] = field(default_factory=list)


def run_lint(paths: Sequence[str | Path], rules: Sequence[Rule]) -> LintReport:
    """Parse each file once, run every in-scope rule, apply suppressions."""
    report = LintReport()
    for path in iter_py_files(paths):
        posix = path.as_posix()
        active = [r for r in rules if r.applies(posix)]
        if not active:
            continue
        try:
            src = path.read_text()
            tree = ast.parse(src, filename=posix)
        except (OSError, SyntaxError) as e:
            report.errors.append(f"{posix}: {e}")
            continue
        report.files_checked += 1
        supp = Suppressions(src, posix)
        report.findings.extend(supp.unjustified)
        for rule in active:
            for f in rule.check(tree, src, posix):
                if not supp.hides(f):
                    report.findings.append(f)
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report
