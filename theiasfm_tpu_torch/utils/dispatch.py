"""Dispatch, kernel-launch and host-sync accounting (port of
theiasfm_tpu/utils/dispatch.py).

Every CUDA kernel wrapper calls count_dispatch(<kernel name>) exactly
where it launches its kernel (never on the plain CPU path), and the
bundle adjuster counts its Schur products S·v under "schur_matvec".
The bundle adjuster also counts each host read of a device value under
"sync.<site>" (host_sync, below: on the card each such read waits for
the device) and each LM step under "lm.accepted" or "lm.rejected". A
run resets the counts, drives the solver, and reads them back to show
that the path really went through the kernels and how often the host
waited.

phase and host_sync are the bundle adjuster's profiler ranges. While a
profiler runs, each phase of an LM iteration is a range of its own name
("ba.<phase>"), and each host read a range "ba.sync" that host_sync
opens after closing the open phase, which it reopens after the read: no
range of the one prefix nests in another, so a device gap that opens
while the host waits inside "ba.sync" is a gap that the read drained.
With no profiler running neither opens a range (a range costs some
microseconds even then), and host_sync only counts.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict

import torch
from torch.profiler import record_function

SYNC_RANGE = "ba.sync"

_counts: Dict[str, int] = collections.Counter()


class _Open(threading.local):
    """The phases open on this thread, as [name, record_function] pairs
    (the sharded solvers run their ranks as threads)."""

    def __init__(self):
        self.phases = []


_open = _Open()


def count_dispatch(site: str, n: int = 1) -> None:
    _counts[site] += n


def dispatch_counts() -> Dict[str, int]:
    return dict(_counts)


def total_dispatches() -> int:
    return sum(_counts.values())


def reset_dispatch_counts() -> None:
    _counts.clear()


def _enter(name: str):
    r = record_function(name)
    r.__enter__()
    return r


@contextlib.contextmanager
def phase(name: str):
    """Run the block as the phase `name`: inside a profiler range of that
    name while a profiler runs, which host_sync closes around each host
    read inside the block; otherwise as it is."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    stack = _open.phases
    entry = [name, _enter(name)]
    stack.append(entry)
    try:
        yield
    finally:
        stack.pop()
        entry[1].__exit__(None, None, None)


@contextlib.contextmanager
def host_sync(site: str, reads: int = 1):
    """Around a host read of device values (bool(), .item(), .tolist(), a
    blocking upload), and nothing else: adds `reads` to "sync.<site>",
    and while a profiler runs holds the block in a range named
    SYNC_RANGE, with this thread's open phases closed around it."""
    count_dispatch("sync." + site, reads)
    if not torch.autograd._profiler_enabled():
        yield
        return
    stack = _open.phases
    for entry in reversed(stack):
        entry[1].__exit__(None, None, None)
    try:
        with record_function(SYNC_RANGE):
            yield
    finally:
        for entry in stack:
            entry[1] = _enter(entry[0])
