"""The judge on the CPU at a small size: a sound run is correct; the
lower-precision control and every planted fault come out not correct."""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.systems import bundle_adjust as sysba

SEED = 2**31 + 12345
PER_CAMERA = "bal_final13682.per_camera_calib"
SHARED = "bal_venice1778.shared_calib"


def _run(bench, workload, solve=None):
    return run.run_cell(workload, SEED, 0.1, False, device="cpu",
                        solve=solve, bench=bench)


def test_sound_run_is_correct(tiny_bench):
    res = _run(tiny_bench, PER_CAMERA)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1


def test_shared_calib_needs_the_kernels(tiny_bench):
    """On the CPU the port launches no kernel: the path check fails the
    run, and nothing else does."""
    res = _run(tiny_bench, SHARED)
    assert not res["correct"]
    assert res["compared"]["kernel_path"]["value"] == 0
    for k, v in res["compared"].items():
        if k != "kernel_path":
            assert v["value"] <= v["limit"], (k, v)


@pytest.mark.parametrize("fault", sorted(sysba.FAULTS))
@pytest.mark.parametrize("workload", [PER_CAMERA, SHARED])
def test_planted_fault_is_not_correct(tiny_bench, workload, fault):
    res = _run(tiny_bench, workload, sysba.FAULTS[fault])
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    over = [k for k, v in res["compared"].items()
            if k != "kernel_path" and v["value"] > v["limit"]]
    assert over, res["compared"]


@pytest.mark.parametrize("workload", [PER_CAMERA, SHARED])
def test_bf16_control_is_not_correct(tiny_bench, workload):
    res = _run(tiny_bench, workload, sysba.reference_solve(torch.bfloat16))
    assert not res["correct"]
    over = [k for k, v in res["compared"].items()
            if k != "kernel_path" and v["value"] > v["limit"]]
    assert over, res["compared"]
