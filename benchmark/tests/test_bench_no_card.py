"""Without a CUDA device a run fails and prints no result: it never falls
back to the CPU."""
from __future__ import annotations

import os
import subprocess
import sys

from conftest import ROOT


def test_run_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "bal_venice1778.shared_calib", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=env)
    assert p.returncode != 0
    assert not any(line.lstrip().startswith("{")
                   for line in p.stdout.splitlines())
    assert "no CUDA device" in p.stderr
