"""Named mesh axes for the sharded solvers: the counterpart of the axis
environment that JAX's `shard_map` binds.

Under `shard_map` a function reduces over a mesh axis by its name
(`jax.lax.psum(x, "obs")`). Here every rank runs the same function
(SPMD), and `bind_axes` maps each axis name to this rank's
`torch.distributed` process group for the length of a `with` block;
`psum(x, axis_name)` then all-reduces over that group, or over the
groups of a tuple of names in turn (a 2-D ("dcn", "ici") mesh reduces
within a row, then across rows).

The binding is thread-local, so ranks that run as threads of one
process (the CPU tests, each thread with its own gloo group) keep
their own bindings. A name that is not bound raises: a psum never turns
into a silent no-op.

Thread ranks also take turns (`taking_turns`): a rank computes only
while it holds a lock that it lets go while it waits in a collective.
Each of torch's small CPU ops lets go of the interpreter lock and takes
it back, and 8 threads contending for it ran such ops at some 44 us an
op against 5.7 us alone (an 8-core CPU host); taking turns, one rank
computes at a time.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict

import torch
import torch.distributed as dist

_local = threading.local()


def _bindings() -> Dict[str, object]:
    if not hasattr(_local, "axes"):
        _local.axes = {}
    return _local.axes


@contextlib.contextmanager
def bind_axes(groups: Dict[str, object]):
    """Bind each axis name of `groups` to its process group in this
    thread while the block runs (an inner binding of a name shadows an
    outer one and is undone after)."""
    axes = _bindings()
    saved = dict(axes)
    axes.update(groups)
    try:
        yield
    finally:
        axes.clear()
        axes.update(saved)


@contextlib.contextmanager
def taking_turns(turn: threading.Lock):
    """Run the block holding `turn` (shared by the thread ranks of one
    process), except while this thread waits in a collective or in
    `off_turn`."""
    turn.acquire()
    _local.turn = turn
    try:
        yield
    finally:
        _local.turn = None
        turn.release()


@contextlib.contextmanager
def off_turn():
    """Let the other thread ranks run while this one waits (a
    collective, a group's rendezvous); a no-op outside taking_turns."""
    turn = getattr(_local, "turn", None)
    if turn is None:
        yield
        return
    turn.release()
    try:
        yield
    finally:
        turn.acquire()


def axis_names(axis_name) -> tuple:
    """A name or a tuple of names as a tuple."""
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def axis_group(name: str):
    """The process group bound to `name` in this thread."""
    try:
        return _bindings()[name]
    except KeyError:
        raise LookupError(
            f"mesh axis {name!r} is not bound: run the sharded solver "
            "through theiasfm_tpu_torch.parallel (or inside "
            "utils.collectives.bind_axes)") from None


def psum_over(axis_name):
    """x -> psum(x, axis_name), or the identity when axis_name is None.
    An unbound name raises here, before the caller does any work."""
    if axis_name is None:
        return lambda x: x
    for name in axis_names(axis_name):
        axis_group(name)
    return functools.partial(psum, axis_name=axis_name)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum of `x` over every rank of the named axis (or axes), returned
    as a new contiguous tensor on every rank; `x` is left as it was."""
    groups = [axis_group(n) for n in axis_names(axis_name)]
    y = x.detach().clone(memory_format=torch.contiguous_format)
    with off_turn():
        for g in groups:
            dist.all_reduce(y, group=g)
    return y
