"""Start the ranks of a sharded run on one host: threads on the CPU,
spawned processes on the card.

`run_ranks(fn, n, device)` calls `fn(ranks, *args)` on n ranks, each
with a `Ranks` that builds its meshes (gloo groups over one store), and
returns the n results in rank order. On the CPU the ranks are threads of
this process over a `HashStore`, which take turns between collectives
(utils/collectives.taking_turns); on CUDA they are processes started with the `spawn` method over a
`TCPStore` on localhost, rank r on card r modulo the card count (NCCL
refuses two ranks on one card; gloo stages CUDA tensors through host
memory). A rank that raises, or a run that outlasts `timeout`, raises
here: no rank's failure is dropped and nothing falls back to fewer ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import threading
import time
import traceback

import torch
import torch.distributed as dist

from ..utils import collectives
from .mesh import Mesh, gloo_mesh

__all__ = ["Ranks", "run_ranks"]


@dataclasses.dataclass
class Ranks:
    """What a rank of run_ranks knows: the store, its rank, the number
    of ranks, its device and the groups' timeout (seconds)."""
    store: object
    rank: int
    size: int
    device: torch.device
    timeout: float
    _meshes: int = 0

    def mesh(self, axis_name="obs", shape=None) -> Mesh:
        """A mesh of all the ranks (shape: row-major, default 1-D). Every
        rank must build the same meshes in the same order."""
        shape = (self.size,) if shape is None else tuple(shape)
        if torch.Size(shape).numel() != self.size:
            raise ValueError(f"mesh shape {shape} for {self.size} ranks")
        self._meshes += 1
        # the groups' rendezvous waits for every rank
        with collectives.off_turn():
            return gloo_mesh(self.store, self.rank, shape, axis_name,
                             self.device, self.timeout,
                             prefix=f"mesh{self._meshes}")


def run_ranks(fn, n_ranks: int, device="cuda", timeout: float = 600.0,
              args=()):
    """fn(ranks, *args) on n_ranks ranks; returns their results in rank
    order. On CUDA, fn, args and the results travel by pickle (fn by
    its import path): return host values, not CUDA tensors."""
    device = torch.device(device)
    if device.type == "cpu":
        return _thread_ranks(fn, n_ranks, timeout, args)
    if device.type != "cuda":
        raise ValueError(f"run_ranks: no ranks on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("run_ranks: device='cuda' but no CUDA device")
    return _process_ranks(fn, n_ranks, timeout, args)


def _raise_failures(errors, what):
    failed = {r: e for r, e in enumerate(errors) if e is not None}
    if failed:
        r, e = next(iter(failed.items()))
        raise RuntimeError(f"rank(s) {sorted(failed)} of {what} failed; "
                           f"rank {r}: {e}")


def _thread_ranks(fn, n, timeout, args):
    store = dist.HashStore()
    turn = threading.Lock()
    results, errors = [None] * n, [None] * n

    def body(r):
        try:
            ranks = Ranks(store, r, n, torch.device("cpu"), timeout)
            with collectives.taking_turns(turn):
                results[r] = fn(ranks, *args)
        except BaseException:  # reported by the caller's thread
            errors[r] = traceback.format_exc()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(n)]
    for t in threads:
        t.start()
    # a failed rank ends the wait at once: the others may be blocked in
    # a collective until the groups' timeout (daemon threads, left to it)
    deadline = time.monotonic() + timeout
    while (any(t.is_alive() for t in threads) and
           not any(errors) and time.monotonic() < deadline):
        time.sleep(0.005)
    _raise_failures(errors, f"{n} thread ranks")
    alive = [r for r, t in enumerate(threads) if t.is_alive()]
    if alive:
        raise TimeoutError(f"ranks {alive} of {n} did not finish within "
                           f"{timeout} s")
    return results


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _process_main(fn, r, n, port, timeout, args, out):
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        store = dist.TCPStore("127.0.0.1", port, n, r == 0,
                              datetime.timedelta(seconds=timeout))
        dev = torch.device("cuda", r % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        out.put((r, True, fn(Ranks(store, r, n, dev, timeout), *args)))
    except BaseException:  # sent to the parent, which raises
        out.put((r, False, traceback.format_exc()))


def _process_ranks(fn, n, timeout, args):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_process_main, name=f"rank{r}",
                         args=(fn, r, n, port, timeout, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors, done = [None] * n, [None] * n, set()
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining: a child joins only after its
        # result has been read. A failed rank ends the wait at once (the
        # others may be blocked in a collective): all are killed below.
        for _ in range(n):
            try:
                r, ok, value = out.get(timeout=max(
                    0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if not ok:
                errors[r] = value
                break
            results[r] = value
            done.add(r)
        if len(done) == n:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    _raise_failures(errors, f"{n} process ranks")
    bad = {r for r, p in enumerate(procs) if p.exitcode != 0}
    bad |= set(range(n)) - done
    if bad:
        raise RuntimeError(f"ranks {sorted(bad)} of "
                           f"{n} did not finish within {timeout} s "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return results
