"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "theiasfm_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "bal").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "dataclasses",
                                          "math", "time", "torch"}, (path,
                                                                     name)


BLOCKED_RUN = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "theiasfm_tpu"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
import torch
torch.set_num_threads(1)
from conftest import shrink
from benchmark import registry, run
import tempfile, pathlib
root = shrink(pathlib.Path(tempfile.mkdtemp()))
res = run.run_cell("bal_final13682.per_camera_calib", 3, 0.1, False,
                   device="cpu", bench=registry.Benchmark(root))
import benchmark.tools.readings
assert res["correct"], res["compared"]
print("LOADED", run.forbidden_modules())
'''


def test_a_run_loads_no_jax(tmp_path):
    p = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(ROOT)],
                       capture_output=True, text=True, timeout=600,
                       cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout
