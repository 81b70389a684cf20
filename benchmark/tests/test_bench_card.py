"""On the card, at a small size: the kernel path runs in shared_calib and
not in per_camera_calib, every run is correct, and the control is not.
Marked `cuda`; skips where no card is present (decided in the fixture)."""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.systems import bundle_adjust as sysba

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload,kernels", [
    ("bal_venice1778.shared_calib", True),
    ("bal_final13682.per_camera_calib", False)])
def test_cell_on_the_card(card, tiny_bench, workload, kernels):
    res = run.run_cell(workload, 2**31 + 9, 0.5, False, bench=tiny_bench)
    assert res["correct"], res["compared"]
    assert res["device"]["platform"] == "gpu"
    note = res["compared"]["kernel_path"]["note"]
    assert ("'schur_pass1': 0" in note) != kernels


@pytest.mark.parametrize("workload", ["bal_venice1778.shared_calib",
                                      "bal_final13682.per_camera_calib"])
def test_control_on_the_card(card, tiny_bench, workload):
    res = run.run_cell(workload, 2**31 + 10, 0.1, False, bench=tiny_bench,
                       solve=sysba.reference_solve(torch.bfloat16))
    assert not res["correct"]
