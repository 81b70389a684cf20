"""Dispatch and kernel-launch accounting (port of
theiasfm_tpu/utils/dispatch.py).

Every CUDA kernel wrapper calls count_dispatch(<kernel name>) exactly
where it launches its kernel (never on the plain CPU path), and the
bundle adjuster counts its Schur products S·v under "schur_matvec".
A run resets the counts, drives the solver, and reads them back to
show that the path really went through the kernels.
"""
from __future__ import annotations

import collections
from typing import Dict

_counts: Dict[str, int] = collections.Counter()


def count_dispatch(site: str, n: int = 1) -> None:
    _counts[site] += n


def dispatch_counts() -> Dict[str, int]:
    return dict(_counts)


def total_dispatches() -> int:
    return sum(_counts.values())


def reset_dispatch_counts() -> None:
    _counts.clear()
