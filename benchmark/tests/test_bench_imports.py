"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark import run, specs

RUN_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run, calibrate
from benchmark.tests._small import CELLS, small
for cell in CELLS:
    for trace in (False, True):
        run.run_cell(cell, 3, 0.2, trace, "cpu", overrides=small(cell))
    calibrate.control_numbers(cell, 4, "cpu", overrides=small(cell))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import specs
from benchmark.reference import solve
cfg = {{**specs.data("configs", "sphere2500"), "n_rings": 4, "poses_per_ring": 6}}
data = specs.module("generators", "sphere").make(cfg, 1)
solve.solve(data, {{"method": "gn", "iterations": 2, "huber": None, "solve": "schur", "blocks": 4}}, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code.format(root=str(specs.ROOT))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(RUN_ALL)
    assert "graphslam_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE)
    assert not mods & (set(run.FORBIDDEN) | {"graphslam_tpu_torch"})
    for path in (specs.ROOT / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in {"__future__", "contextlib", "math", "numpy", "torch", "benchmark"}, \
                    f"{path.name} imports {n}"
                if n.startswith("benchmark"):
                    assert n.startswith("benchmark.reference"), f"{path.name} imports {n}"
