"""The bundle adjuster's host reads of device values (utils/dispatch
host_sync, counted under sync.<site>), its LM step counts (lm.accepted,
lm.rejected) and its profiler ranges (ba.<phase>, ba.sync), at the
solver options of the benchmark's two cells (benchmark/configs): CG
fixed at cg_iterations products (cg_tol 0, cg_eta 0), with and without
the fused-matvec plan. On the CPU the counts and ranges; on the card
(marked cuda) every synchronizing call that torch's sync debug mode
reports is a counted one.

On the card: python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_ba_syncs.py -q -s
"""
from __future__ import annotations

import collections
import dataclasses
import json
import traceback
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from theiasfm_tpu_torch.bench_problem import make_problem
from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
from theiasfm_tpu_torch.utils import dispatch
from theiasfm_tpu_torch.utils.dispatch import (dispatch_counts,
                                               reset_dispatch_counts)

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
CELLS = {"venice": "bal_venice1778", "final": "bal_final13682"}
BLOCK = 512
# the operators of one host read, as the CPU profiler shows them: bool()
# (is_nonzero), .tolist() (resolve_conj, resolve_neg), an upload
# (torch.tensor: lift_fresh, detach_, empty, to; setitem with a list index:
# index_put_), and bincount, which reads its ids' least and largest values
READ_OPS = {"aten::is_nonzero", "aten::item", "aten::_local_scalar_dense",
            "aten::resolve_conj", "aten::resolve_neg", "aten::lift_fresh",
            "aten::detach_", "aten::empty", "aten::to", "aten::_to_copy",
            "aten::copy_", "aten::index_put_", "aten::bincount"}


def _case(cell, plan, device="cpu", iterations=3, n_cams=8, n_pts=200):
    """A small problem and the cell's solver options: one intrinsics group
    for venice, a group per camera for final (BAL's own), observations
    padded to the plan's block and the plan attached when `plan`; "dense"
    is venice's options with the dense Schur solver."""
    cfg = json.loads((CONFIGS / f"{CELLS.get(cell, CELLS['venice'])}.json"
                      ).read_text())
    active = set(cfg["optimize_intrinsics"])
    opts = ba.BAOptions(
        optimize_intrinsics=tuple(i in active for i in range(10)),
        max_iterations=iterations, **cfg["solver"])
    p = make_problem(n_cams, n_pts, 4, device=device, perturb_seed=3)
    if cell == "final":
        p = p._replace(intrinsics=p.intrinsics.repeat(n_cams, 1),
                       obs_group=p.obs_cam.clone())
    p = ba.pad_obs_to_multiple(p, BLOCK)
    if cell == "dense":
        opts = dataclasses.replace(opts, linear_solver="dense_schur")
        p = ba.add_point_obs_map(p)
    if plan:
        p = ba.add_pallas_matvec_plan(p, block=BLOCK)
    return p, opts


def _syncs():
    return {k[len("sync."):]: v for k, v in dispatch_counts().items()
            if k.startswith("sync.") and v}


@pytest.mark.parametrize("cell,plan", [("venice", True), ("venice", False),
                                       ("final", False), ("dense", False)],
                         ids=["venice-kernels", "venice-plain", "final",
                              "dense"])
def test_sync_counts_per_solve_and_iteration(cell, plan):
    """Two solves: per LM iteration one CG stopping test per product, one
    step read and four uploads (the active intrinsics slots, two for the
    Hpp diagonal's setitem, CG's guard); per solve two uploads (the active
    slots' index, lambda) and, on the kernel path, the index check's two
    reads, the point order and bincount's two reads for each of the
    camera and point segments. The dense solver runs no CG: its pairs of
    observations cost one read a solve."""
    prob, opts = _case(cell, plan)
    assert ba.kernels_eligible(prob, opts) == (cell == "venice" and plan)
    reset_dispatch_counts()
    iters = sum(ba.bundle_adjust(prob, opts)[1].num_iterations
                for _ in range(2))
    assert iters == 2 * opts.max_iterations
    cg = 0 if cell == "dense" else opts.cg_iterations
    want = {"lm_step": iters, "upload": 3 * iters + 2 * 2}
    if cg:
        want.update(cg_stop=iters * cg, upload=4 * iters + 2 * 2)
    else:
        want.update(point_pairs=2)
    if ba.kernels_eligible(prob, opts):
        want.update(index_check=2 * 2, point_order=2, segment_count=2 * 4)
    assert _syncs() == want
    c = dispatch_counts()
    assert c.get("schur_matvec", 0) == iters * cg
    assert c.get("lm.accepted", 0) + c.get("lm.rejected", 0) == iters


def test_rejected_steps_are_the_negative_trace_entries():
    """lm.rejected counts the steps BASummary.cost_trace records as
    negative (rejected candidates); this start rejects some."""
    prob, opts = _case("venice", True, iterations=6)
    opts = dataclasses.replace(opts, trace_costs=True)
    reset_dispatch_counts()
    _, s = ba.bundle_adjust(prob, opts)
    c = dispatch_counts()
    rejected = int((s.cost_trace < 0).sum())
    assert rejected >= 1
    assert c.get("lm.rejected", 0) == rejected
    assert c.get("lm.accepted", 0) == s.num_iterations - rejected


@pytest.mark.parametrize("cell", ["venice", "final"])
def test_ranges_do_not_nest_and_sync_ranges_hold_only_reads(cell):
    """Under torch.profiler no two ba.* ranges overlap (ba.sync closes the
    phase around each read), and each ba.sync range holds the read's own
    operators and none of the solve's."""
    prob, opts = _case(cell, cell == "venice", iterations=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reset_dispatch_counts()
        ba.bundle_adjust(prob, opts)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name.startswith("ba."))
    names = collections.Counter(s[2] for s in spans)
    assert {"ba.linearize", "ba.blocks", "ba.rhs", "ba.precond", "ba.cg",
            "ba.backsub", "ba.inner", "ba.cost", "ba.sync"} <= set(names)
    for a, b in zip(spans, spans[1:]):
        assert b[0] >= a[1], (a, b)
    # a range for each host_sync: the index check's two reads, bincount's
    # two and the diagonal's two take one range each
    syncs = _syncs()
    ranges = (sum(syncs.values()) - opts.max_iterations -
              syncs.get("index_check", 0) // 2 -
              syncs.get("segment_count", 0) // 2)
    assert names["ba.sync"] == ranges
    for e in events:
        if e.name == dispatch.SYNC_RANGE:
            ops = {c.name for c in e.cpu_children}
            assert ops and ops <= READ_OPS, ops


def test_no_range_without_a_profiler(monkeypatch):
    """With no profiler running the phases and the host reads open no
    range: each read is one counter increment."""
    def refuse(name):
        raise AssertionError(f"range {name} opened without a profiler")
    monkeypatch.setattr(dispatch, "record_function", refuse)
    prob, opts = _case("venice", True, iterations=1)
    reset_dispatch_counts()
    ba.bundle_adjust(prob, opts)
    assert _syncs()["cg_stop"] == opts.cg_iterations


def _port_line(stack):
    """file:line of the innermost frame of the port in a stack."""
    for f in reversed(stack):
        if "theiasfm_tpu_torch" in f.filename:
            return f"{Path(f.filename).name}:{f.lineno}"
    return "outside the port"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["venice", "final", "dense"])
def test_every_card_sync_is_counted(cell):
    """On the card, at the cell's options (the kernels for venice, the
    plain path for final, the dense Schur solver with venice's other
    options): the synchronizing calls torch's sync debug
    mode warns of during a solve are as many as the sync.* counts. Each
    warning is placed at the port's line that made it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob, opts = _case(cell, cell == "venice", device="cuda", n_cams=40,
                       n_pts=2000)
    assert ba.kernels_eligible(prob, opts) == (cell == "venice")
    ba.bundle_adjust(prob, dataclasses.replace(opts, max_iterations=1))
    torch.cuda.synchronize()
    reset_dispatch_counts()
    where = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            where[_port_line(traceback.extract_stack())] += 1

    # the mode's first setting in a process warns by itself: set it first
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            ba.bundle_adjust(prob, opts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counted = sum(_syncs().values())
    print(f"\n{cell}: {sum(where.values())} synchronizing calls, "
          f"{counted} counted {_syncs()}; at {dict(where)}")
    assert "outside the port" not in where
    assert sum(where.values()) == counted, (dict(where), _syncs())
