"""The port's lint: SPMD safety of its host-driven loops, and its
collective audit.

Two layers, as the reference's ``repro.analysis`` (DESIGN.md §9):

- the **AST rules** (``engine.run_lint``): ``key-reuse`` on the port's
  threefry keys, ``id-overflow`` on int32 id packings, and the SPMD rules
  ``divergent-collective``, ``nonuniform-loop`` and ``host-sync``, judged
  by a shard-uniformity dataflow over host-driven control flow
  (``uniformity.py``);
- the **collective audit** (``collective_audit.run_audit``): the entry
  points run on a ``torch.distributed`` world with recorders around the
  calls ``core/comm.py`` makes; every rank must issue the same sequence,
  ``scheme="auto"`` the sequence of the scheme it resolves to, and a
  family of plan signatures one program build each.

CLI: ``python -m repro_torch.analysis src/repro_torch [--audit]``.
"""
from .engine import (ANALYSIS_RULES, RULES, FileContext, LintResult,
                     lint_source, run_lint)
from .findings import (BASELINE, Finding, count_suppressions, load_baseline,
                       parse_suppressions, split_baselined, write_baseline)

__all__ = [
    "ANALYSIS_RULES", "BASELINE", "RULES", "FileContext", "LintResult",
    "Finding", "lint_source", "run_lint", "count_suppressions",
    "parse_suppressions", "load_baseline", "split_baselined",
    "write_baseline",
]
