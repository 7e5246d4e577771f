"""Rule registry + file walker: the AST layer of the port's lint.

``run_lint`` walks the targets, parses each Python file once, runs the
shard-uniformity analysis once, hands the shared context to every rule,
then subtracts inline suppressions and the baseline.  One
``modules.ModuleIndex`` serves the whole run, so a module summarised for
one file's calls is parsed once.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path

from . import rules_numeric, rules_rng, rules_spmd, uniformity
from .findings import (Finding, is_suppressed, load_baseline,
                       parse_suppressions, split_baselined)
from .modules import ModuleIndex

#: rule id -> checker.  Checkers take a :class:`FileContext` and return
#: findings; ids are what suppressions and the baseline refer to.
RULES = {
    "key-reuse": rules_rng.check_key_reuse,
    "id-overflow": rules_numeric.check_id_overflow,
    "host-sync": rules_spmd.check_host_sync,
    "divergent-collective": rules_spmd.check_divergent_collective,
    "nonuniform-loop": rules_spmd.check_nonuniform_loop,
}

# Rules that need the uniformity analysis.
ANALYSIS_RULES = {"host-sync", "divergent-collective", "nonuniform-loop"}


@dataclasses.dataclass
class FileContext:
    """Everything a rule may look at for one file."""

    path: str                       # root-relative posix path
    source: str
    tree: ast.Module
    info: object                    # modules.ModuleInfo
    analysis: object | None         # uniformity.ModuleAnalysis | None


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]         # new (non-baselined, non-suppressed)
    baselined: list[Finding]
    suppressed: int
    n_files: int
    errors: list[str]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def iter_py_files(targets: list, root: Path) -> list[Path]:
    files: list[Path] = []
    for t in targets:
        p = Path(t) if Path(t).is_absolute() else root / t
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def analyze(source: str, path: str, rules: list[str] | None = None,
            errors: list[str] | None = None, *, root: str | Path = ".",
            index: ModuleIndex | None = None) -> FileContext | None:
    """Parse one file and run its canonical uniformity pass (the rules
    read the context once every file of the run is analysed: a call in
    one module reports what the callee does with its arguments in the
    callee's module)."""
    rule_ids = list(rules) if rules is not None else list(RULES)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        (errors if errors is not None else []).append(f"{path}: {e}")
        return None
    index = ModuleIndex() if index is None else index
    info = index.module_of(tree, Path(root) / path)
    analysis = None
    if any(r in ANALYSIS_RULES for r in rule_ids):
        try:
            analysis = uniformity.ModuleAnalysis.of(info)
            analysis.path = path
            analysis.run()
        except RecursionError as e:   # fail open, loudly
            analysis = None
            msg = f"{path}: uniformity analysis failed: {e!r}"
            if errors is not None:
                errors.append(msg)
            else:
                print(f"repro-torch-lint: {msg}", file=sys.stderr)
    return FileContext(path=path, source=source, tree=info.tree, info=info,
                       analysis=analysis)


def check(ctx: FileContext, rules: list[str] | None = None
          ) -> list[Finding]:
    """The findings of one analysed file, suppressions applied."""
    suppressions = parse_suppressions(ctx.source)
    out = [f for rid in (rules if rules is not None else RULES)
           for f in RULES[rid](ctx) if not is_suppressed(f, suppressions)]
    return sorted(set(out))


def lint_source(source: str, path: str, rules: list[str] | None = None,
                errors: list[str] | None = None, *, root: str | Path = ".",
                index: ModuleIndex | None = None) -> list[Finding]:
    """Lint one in-memory source blob (fixture tests call this directly).

    ``path`` matters: ``host-sync`` judges only ``kernels/``, and a path
    that exists under ``root`` lets the analysis read the other modules of
    its package.  Suppressions are applied, the baseline is not.
    """
    ctx = analyze(source, path, rules, errors, root=root, index=index)
    return [] if ctx is None else check(ctx, rules)


def run_lint(targets: list, root: str | Path = ".",
             baseline: str | Path | None = None,
             rules: list[str] | None = None) -> LintResult:
    """Lint every ``*.py`` under ``targets`` (paths relative to ``root``)."""
    root = Path(root).resolve()
    errors: list[str] = []
    suppressed = 0
    index = ModuleIndex()
    files = iter_py_files(targets, root)
    ctxs = []
    for p in files:
        try:
            source = p.read_text()
        except OSError as e:
            errors.append(f"{p}: {e}")
            continue
        rp = p.resolve()
        rel = rp.relative_to(root).as_posix() if rp.is_relative_to(
            root) else rp.as_posix()
        suppressed += len(parse_suppressions(source))
        ctx = analyze(source, rel, rules, errors, root=root, index=index)
        if ctx is not None:
            ctxs.append(ctx)
    all_findings = [f for ctx in ctxs for f in check(ctx, rules)]
    base = load_baseline(baseline) if baseline else set()
    new, old = split_baselined(all_findings, base)
    return LintResult(findings=new, baselined=old, suppressed=suppressed,
                      n_files=len(files), errors=errors)
