"""Findings, inline suppressions and the port's baseline.

A :class:`Finding` is one rule hit at one source location.  Two escape
hatches exist, as in the reference's ``repro.analysis.findings``:

- **inline suppressions** — a comment ``repro-torch-lint: disable=<rule>``
  (after a ``#``, rules separated by commas, ``all`` for every rule) on
  the offending line silences those rules for that line only.  The
  self-check pins ``src/repro_torch/{core,kernels,launch}`` to *zero* of
  them: the port's host loops must satisfy the rules outright, through
  real fixes or ``comm.shard_uniform`` contracts.
- **the baseline** — ``baseline.json`` beside this module lists known
  findings as ``{path, rule, message}`` records.  Matching ignores line
  numbers.  The port's baseline is empty, and stays so.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

SUPPRESS_RE = re.compile(r"#\s*repro-torch-lint:\s*disable=([\w,\- ]+)")
BASELINE = Path(__file__).with_name("baseline.json")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location."""

    path: str          # root-relative posix path
    line: int          # 1-based source line
    rule: str          # rule id, e.g. "key-reuse"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def key(self) -> tuple:
        """Baseline identity: line numbers are deliberately excluded."""
        return (self.path, self.rule, self.message)


def parse_suppressions(source: str) -> dict[int, set[str]]:
    """Map line number -> set of rule ids disabled on that line."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def is_suppressed(f: Finding, suppressions: dict[int, set[str]]) -> bool:
    rules = suppressions.get(f.line)
    return bool(rules) and (f.rule in rules or "all" in rules)


def count_suppressions(source: str) -> int:
    """Number of inline suppression comments in ``source``."""
    return len(parse_suppressions(source))


def load_baseline(path: str | Path = BASELINE) -> set[tuple]:
    """The baseline as a set of :meth:`Finding.key` tuples (empty when the
    file is missing)."""
    p = Path(path)
    if not p.exists():
        return set()
    return {(r["path"], r["rule"], r["message"])
            for r in json.loads(p.read_text())}


def write_baseline(findings: list[Finding], path: str | Path) -> None:
    """Write ``findings`` as a baseline file."""
    records = [dict(path=f.path, rule=f.rule, message=f.message)
               for f in sorted(set(findings))]
    Path(path).write_text(json.dumps(records, indent=2, sort_keys=True) + "\n")


def split_baselined(findings: list[Finding], baseline: set[tuple]
                    ) -> tuple[list[Finding], list[Finding]]:
    """Partition into (new, baselined), matching on (path, rule, message)."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old
