"""No module that a run loads has the top-level name of JAX or of the JAX
package (compared whole: the port's name begins with the JAX package's),
and the reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH, ROOT

LOAD_RUN = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import json
sys.argv = ["run.py"]
import colorbench.run, colorbench.harness, colorbench.program
import colorbench.control
from colorbench import harness
m = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for w in m["workloads"]:
    for trace in (False, True):
        harness.load_cell({str(ROOT / 'BENCHMARK.json')!r}, harness.BENCH_DIR,
                          w["name"], trace)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import sys, json
sys.path[:0] = [{str(ROOT)!r}]
import colorbench.reference, colorbench.yardstick, colorbench.graphs
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(__import__("json").loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = loaded(LOAD_RUN)
    assert "repro_torch" in top and "colorbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_the_reference_loads_nothing_of_the_program():
    top = loaded(LOAD_REFERENCE)
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, top


def test_the_reference_imports_only_torch():
    tree = ast.parse((BENCH / "reference.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "torch"}, names
