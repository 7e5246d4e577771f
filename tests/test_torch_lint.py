"""Tests for the port's lint (``src/repro_torch/analysis``).

1. Per-rule fixtures (``tests/lint_fixtures_torch``), as the reference's
   ``RULE_FIXTURES``: every line of a positive fixture marked ``# FIRE``
   gives exactly one finding of its rule and no other; a negative fixture
   gives none.
2. Mechanisms: inline suppressions, the baseline, rendering, the
   ``host-sync`` scope and the CLI's exit codes.
3. The self-check: ``src/repro_torch/{core,kernels,launch}`` lint clean
   with zero suppressions, and so does the whole port.
4. Mutations: a copy of the port with one of its reductions removed (the
   host read that then steers an exchange is per rank) must fire.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (BASELINE, RULES, Finding,
                                  count_suppressions, lint_source,
                                  load_baseline, run_lint, split_baselined,
                                  write_baseline)
from repro_torch.analysis.__main__ import main as cli_main

FIXTURES = Path(__file__).parent / "lint_fixtures_torch"
REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "src" / "repro_torch"

# rule -> (positive fixture, negative fixture, virtual path prefix or None)
RULE_FIXTURES = {
    "key-reuse": ("key_reuse_pos.py", "key_reuse_neg.py", None),
    "id-overflow": ("id_overflow_pos.py", "id_overflow_neg.py", None),
    "host-sync": ("host_sync_pos.py", "host_sync_neg.py", "kernels"),
    "divergent-collective": ("divergent_collective_pos.py",
                             "divergent_collective_neg.py", "core"),
    "nonuniform-loop": ("nonuniform_loop_pos.py", "nonuniform_loop_neg.py",
                        "core"),
}


def fire_lines(path: Path) -> set[int]:
    return {i for i, line in enumerate(path.read_text().splitlines(), 1)
            if "# FIRE" in line}


def lint_fixture(name: str, prefix: str | None) -> list[Finding]:
    errors: list[str] = []
    findings = lint_source((FIXTURES / name).read_text(),
                           f"{prefix}/{name}" if prefix else name,
                           errors=errors)
    assert not errors, errors
    return findings


@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_rule_fires_on_positive_fixture(rule):
    pos, _, prefix = RULE_FIXTURES[rule]
    expected = fire_lines(FIXTURES / pos)
    assert expected, f"{pos} has no # FIRE markers"
    got = {(f.rule, f.line) for f in lint_fixture(pos, prefix)}
    assert got == {(rule, line) for line in expected}


@pytest.mark.parametrize("rule", sorted(RULE_FIXTURES))
def test_rule_quiet_on_negative_fixture(rule):
    _, neg, prefix = RULE_FIXTURES[rule]
    findings = lint_fixture(neg, prefix)
    assert findings == [], [f.render() for f in findings]


def test_all_rules_have_fixtures():
    assert set(RULE_FIXTURES) == set(RULES)


DEMO = ("from repro_torch import rng\n"
        "def f(key):\n"
        "    a = rng.bits(key, 4)\n"
        "    b = rng.permutation(key, 4){pragma}\n"
        "    return a, b\n")


def test_inline_suppression_silences_one_rule():
    pragma = "  # repro-torch-lint: disable=key-reuse"
    src = DEMO.format(pragma=pragma)
    assert lint_source(src, "demo.py") == []
    assert [f.rule for f in lint_source(DEMO.format(pragma=""),
                                        "demo.py")] == ["key-reuse"]
    assert count_suppressions(src) == 1


def test_suppression_is_rule_scoped():
    src = DEMO.format(pragma="  # repro-torch-lint: disable=id-overflow")
    assert [f.rule for f in lint_source(src, "demo.py")] == ["key-reuse"]


def test_reference_pragma_is_not_the_ports():
    # the reference's pragma silences nothing here (and the reverse)
    src = DEMO.format(pragma="  # repro-lint: disable=key-reuse")
    assert count_suppressions(src) == 0
    assert [f.rule for f in lint_source(src, "demo.py")] == ["key-reuse"]


def test_baseline_roundtrip_and_split(tmp_path):
    f1 = Finding(path="a.py", line=3, rule="key-reuse", message="m1")
    f2 = Finding(path="b.py", line=9, rule="id-overflow", message="m2")
    bl = tmp_path / "baseline.json"
    write_baseline([f1], bl)
    keys = load_baseline(bl)
    assert f1.key() in keys and f2.key() not in keys
    assert split_baselined([f1, f2], keys) == ([f2], [f1])
    drifted = Finding(path="a.py", line=30, rule="key-reuse", message="m1")
    assert split_baselined([drifted], keys) == ([], [drifted])
    assert load_baseline(tmp_path / "missing.json") == set()


def test_finding_render_is_clickable():
    f = Finding(path="core/x.py", line=7, rule="host-sync", message="boom")
    assert f.render() == "core/x.py:7: [host-sync] boom"


def test_port_baseline_is_valid_and_empty():
    assert BASELINE.parent == PORT / "analysis"
    assert json.loads(BASELINE.read_text()) == []


def test_host_sync_judges_the_wrappers_not_the_plain_versions():
    src = "def f(t):\n    return t.sum().tolist()\n"
    assert [f.rule for f in lint_source(src, "kernels/ops.py")] == [
        "host-sync"]
    assert lint_source(src, "kernels/ref.py") == []
    assert lint_source(src, "core/loop.py") == []


def test_core_kernels_launch_lint_clean_with_zero_suppressions():
    """The acceptance bar: no finding and no pragma in the port's loops,
    kernels and launchers."""
    targets = [PORT / "core", PORT / "kernels", PORT / "launch"]
    result = run_lint(targets, root=REPO_ROOT)
    assert result.n_files > 0 and result.errors == []
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.suppressed == 0
    assert sum(count_suppressions(p.read_text()) for t in targets
               for p in t.rglob("*.py")) == 0


def test_whole_port_lints_clean(monkeypatch, capsys):
    monkeypatch.chdir(REPO_ROOT)
    assert cli_main(["src/repro_torch"]) == 0
    out = capsys.readouterr().out
    assert "0 new finding(s) [clean], 0 baselined, 0 suppression(s)" in out


def test_cli_exit_codes(monkeypatch, capsys):
    monkeypatch.chdir(REPO_ROOT)
    pos = "tests/lint_fixtures_torch/key_reuse_pos.py"
    assert cli_main([pos]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{pos}:9: [key-reuse] ")
    assert cli_main(["tests/lint_fixtures_torch/key_reuse_neg.py"]) == 0


def test_cli_module_runs():
    env = {"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         "tests/lint_fixtures_torch/nonuniform_loop_pos.py"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 1, run.stderr
    assert "[nonuniform-loop]" in run.stdout


def test_sparse_rounds_contract_holds():
    """``comm.sparse_rounds`` asserts with ``shard_uniform`` that every
    shard's row of ``shift_to_round`` is the plan's one table: so for a
    partition's plan and for a bucket's union plan."""
    import numpy as np

    import repro_torch.core as T
    pgs = [T.partition_graph(T.rmat.rmat_er(7, 8, seed=s), 4)
           for s in (1, 2)] + [T.partition_graph(T.rmat.grid2d(16, 16, 9),
                                                 4)]
    tables = [pg.arrays()["shift_to_round"] for pg in pgs]
    for b in T.bucket_graphs(pgs, round_pow2=True):
        tables += [b.member_arrays(j)["shift_to_round"] for j in range(b.B)]
    for t in tables:
        assert (t == t[:1]).all()
        assert T.comm.sparse_rounds({"shift_to_round": t}) == int(
            np.sum(t[0] >= 0))


# a reduction each, whose removal leaves a per-rank host read steering an
# exchange or a collective loop
MUTATIONS = {
    "frontier-not-reduced": (
        "core/speculative.py", "lane_max = comm.pmax(torch.cat(",
        "lane_max = (torch.cat(", {"speculative.py"}),
    "piggyback-events-not-reduced": (
        "core/recolor.py",
        "        needed = comm.lane_pmax(needed[:, :max_colors + 1])",
        "        needed = needed[:, :max_colors + 1]", {"recolor.py"}),
    "class-sizes-not-reduced": (
        "core/recolor.py", "    sizes = comm.lane_psum(sizes.view(L, mc))",
        "    sizes = sizes.view(L, mc)", {"recolor.py", "pipeline.py"}),
    "sparse-rounds-contract-removed": (
        "core/comm.py",
        '    return shard_uniform(int((arrs["shift_to_round"][0] >= 0)'
        '.sum()))',
        '    return int((arrs["shift_to_round"][0] >= 0).sum())',
        {"recolor.py"}),
}


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("mutant")
    shutil.copytree(PORT, root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    return root


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_removed_reduction_fires(port_copy, name):
    rel, old, new, where = MUTATIONS[name]
    path = port_copy / "src" / "repro_torch" / rel
    src = path.read_text()
    assert src.count(old) == 1
    path.write_text(src.replace(old, new))
    try:
        result = run_lint(["src/repro_torch/core"], root=port_copy)
    finally:
        path.write_text(src)
    files = {Path(f.path).name for f in result.findings}
    assert where <= files, [f.render() for f in result.findings]
    assert {f.rule for f in result.findings} <= {"divergent-collective",
                                                 "nonuniform-loop"}
