"""The exact-solver BAL cells' system under test: the port's bundle
adjuster with its dense Schur solver (`linear_solver="dense_schur"`).

The surface of the port this module calls, beyond what
systems/bundle_adjust.py calls:

* `theiasfm_tpu_torch.sfm.ba.bundle_adjustment.add_point_obs_map` (the
  per-point observation table the dense solver pairs observations from);
* the dense solver's counters in `utils/dispatch`: `dense.factor` (one
  a factorization), `dense.corr`, `dense.pairs`, `dense.factor_failed`.

Set-up makes the scene from the seed as systems/bundle_adjust.py does
and prepares the problem as a user of the dense solver does:
observations padded to a multiple of that module's block, then the
point-observation map attached, both before the warm-up. The warm-up is
one LM iteration at the cell's shapes; a port that counts no
factorization in it cannot show that the exact solve ran, and the run
stops there. The window, the release and the judge are that module's:
whole solves from fresh starts, judged against the float64 reference's
minimum. `reference_solve` and `FAULTS` are its own too, and run here
on this cell's problem.
"""
from __future__ import annotations

import dataclasses

import torch

from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as port_ba
from theiasfm_tpu_torch.utils import dispatch as port_dispatch

from ..bal import generator
from . import bundle_adjust as base
from .bundle_adjust import FAULTS, reference_solve  # noqa: F401

# every kernel launch the port counts: none runs in the dense solve
LAUNCHES = base.KERNELS + ("schur_pass1_groups", "schur_pass2_groups")


class Cell(base.Cell):
    """One exact-solver cell's set-up, window and check. `solve`, when
    given, replaces the port (systems/bundle_adjust.py Cell)."""

    def __init__(self, config, traffic, seed, device="cuda", solve=None,
                 log=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = log or (lambda msg: None)
        self.scene = generator.make_scene(config, traffic, seed,
                                          self.device)
        self._sync()
        self.log("scene made")
        self.opts = base.port_options(config, traffic)
        if self.opts.linear_solver != "dense_schur":
            raise ValueError("an exact-solver cell needs linear_solver "
                             "'dense_schur'")
        sc = self.scene
        extr0, pts0 = generator.start(sc, traffic, seed, -1)
        prob = port_ba.BAProblem(
            extrinsics=extr0, intrinsics=sc.intrinsics, points=pts0,
            obs_cam=sc.obs_cam.to(torch.int32),
            obs_group=sc.obs_group.to(torch.int32),
            obs_pt=sc.obs_pt.to(torch.int32), obs_pix=sc.obs_pix,
            obs_mask=sc.obs_mask)
        prob = port_ba.pad_obs_to_multiple(prob, base.PLAN_BLOCK)
        self.problem = port_ba.add_point_obs_map(prob)
        self.scene = dataclasses.replace(
            sc, obs_cam=None, obs_group=None, obs_pt=None, obs_pix=None,
            obs_mask=None)
        self._full = None
        del sc, prob
        self.solve = solve or base.port_solve
        self._sync()
        self.log("problem prepared")
        # warm-up: one LM iteration at the cell's shapes; it also finds
        # the number of observation pairs
        port_dispatch.reset_dispatch_counts()
        self.solve(self, extr0, pts0, iterations=1)
        self._sync()
        counts = port_dispatch.dispatch_counts()
        self.pairs = counts.get("dense.pairs", 0)
        if solve is None and counts.get("dense.factor", 0) != 1:
            raise RuntimeError(
                "the port counted no dense factorization in the warm-up "
                f"(counts {counts}): it cannot show its exact solve")
        self.log(f"warm-up done: {self.pairs} observation pairs")

    def shapes(self) -> dict:
        """What the dense solver's byte and operation counts need."""
        p = self.problem
        return {"M": p.obs_cam.shape[0], "Nc": p.extrinsics.shape[0],
                "Ng": p.intrinsics.shape[0], "Np": p.points.shape[0],
                "P": len(self.config["optimize_intrinsics"]),
                "pairs": self.pairs}

    def path_check(self, win: base.Window):
        """(ok, message): no Schur product and no kernel launch, and one
        dense factorization for every LM step of the window."""
        c = win.counts
        steps = c.get("lm.accepted", 0) + c.get("lm.rejected", 0)
        got = {"schur_matvec": c.get("schur_matvec", 0),
               "launches": sum(c.get(k, 0) for k in LAUNCHES),
               "dense.factor": c.get("dense.factor", 0)}
        want = {"schur_matvec": 0, "launches": 0, "dense.factor": steps}
        if not steps or got != want:
            return False, f"counted {got}, expected {want}: {c}"
        return True, f"{steps} dense factorizations, one an LM step"
