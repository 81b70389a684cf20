"""Shared fixtures of the benchmark's own tests (CPU, small shapes)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# counts that keep the BAL cells' shapes (tracks of at least 2, several
# cameras a point) at a size a CPU test holds
TINY = {"bal_venice1778": (40, 3000, 15100),
        "bal_final13682": (60, 3000, 19500)}


def shrink(root: Path, counts=TINY) -> Path:
    """A copy of the benchmark under `root` with the configurations' counts
    cut to `counts`; returns `root`."""
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for name, (c, p, m) in counts.items():
        f = root / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(f.read_text())
        cfg.update(cameras=c, points=p, observations=m)
        f.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def tiny_bench(tmp_path):
    from benchmark import registry
    return registry.Benchmark(shrink(tmp_path))


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    """Workers of a parallel test run share the cores: one thread each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
