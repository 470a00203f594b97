"""repro-lint for the PyTorch port: static analysis of ``src/repro_torch``
(the port's twin of ``repro/analysis``).

Two layers:

* **AST lints** (:mod:`.rules`, ``python -m repro_torch.analysis``) — the
  reference's five rule ids recast for PyTorch (R1 host-sync safety, R2
  recompilation hazard, R3 typed backpressure, R4 cache-key completeness,
  R5 dtype drift) over :mod:`.base`'s rule engine, with
  mandatory-justification suppression comments;
* **contract audits** (:mod:`.contracts`, ``python -m
  repro_torch.analysis.contracts``) — run representative calls under a
  ``TorchDispatchMode`` and short engine schedules, and assert what the
  lints cannot see: an integer-only stream multiplier and no half
  precision on the SC-GEMM count path, one reduction structure for the
  paged and the gathered-dense decode attention, one capture per shape,
  and the prefix cache's copy-on-write protocol.

Importing this package touches no device; only the audits do.
"""
from .base import Finding, Rule, Suppressions, run_lint
from .rules import DEFAULT_RULES

__all__ = ["Finding", "Rule", "Suppressions", "run_lint", "DEFAULT_RULES"]
