"""The port's independence from JAX, checked by importing: in a fresh
interpreter where `jax` and the JAX package cannot be imported
(sys.modules entries set to None), every module of theiasfm_tpu_torch
and chip_smoke.py (with all it imports) import, and the new solver
modules run a small problem on the CPU. Entry points that build their
own tensors default to the card and raise without one."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_BLOCK = """
import sys
for name in ("jax", "jaxlib", "theiasfm_tpu"):
    sys.modules[name] = None
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", _BLOCK + textwrap.dedent(
        code)], cwd=REPO, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    r = _run("""
        import importlib, pkgutil
        import theiasfm_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = [m for m in sys.modules if m == "jax" or
               m.startswith(("jax.", "jaxlib", "theiasfm_tpu.")) or
               m == "theiasfm_tpu"]
        assert not [m for m in bad if sys.modules[m] is not None], bad
        print(len(names))
    """)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) > 60


def test_solvers_run_without_jax():
    r = _run("""
        import numpy as np, torch
        from theiasfm_tpu_torch import solver_problems as sp
        for name in sp.MINIMAL_SOLVERS:
            x, truth = sp.minimal_problems(name, 0, 4)
            out = sp.run_minimal(name, x, torch.float64, "cpu")
            assert sp.minimal_hits(name, out, truth).shape == (4,)
        print("ok")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_minimal_sweep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from theiasfm_tpu_torch import solver_problems as sp
    x, _ = sp.minimal_problems("known_rotation", 0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.run_minimal("known_rotation", x)
