"""The BAL cells' system under test: the port's bundle adjuster.

The surface of the port this module calls, and all of it:

* `theiasfm_tpu_torch.sfm.ba.bundle_adjustment`: `BAProblem`,
  `BAOptions`, `pad_obs_to_multiple`, `add_pallas_matvec_plan`,
  `bundle_adjust` (its answer's `extrinsics`, `intrinsics`, `points`
  and its summary's `final_cost`, `num_iterations`);
* `theiasfm_tpu_torch.utils.dispatch`: `reset_dispatch_counts`,
  `dispatch_counts` (the Schur products and the kernel launches).

Set-up makes the scene from the seed (benchmark/bal/generator.py), hands
the port its observations, intrinsics and a starting state as a
`BAProblem`, prepares it as a user of the kernels does (observations
padded to a multiple of the plan's block; the fused-matvec plan attached
only where one intrinsics group makes the kernels eligible) and runs one
LM iteration at the cell's own shapes. The window then runs whole solves
back to back, each from a fresh start drawn from the seed, and starts no
new solve once its seconds have passed. Afterwards the reference finds
the problem's minimum in float64, and every solve's answer is judged
against it (benchmark/bal/compare.py).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as port_ba
from theiasfm_tpu_torch.utils import dispatch as port_dispatch

from ..bal import compare, generator, reference

PLAN_BLOCK = 512
# the reference's solve from the truth stops once a step lowers the cost
# by less than this share of it, or after the configuration's
# `reference_iterations`
REFERENCE_TOL = 1e-9
KERNELS = ("schur_pass1", "schur_pass2", "ba_blocks")


@dataclasses.dataclass
class Answer:
    extrinsics: torch.Tensor
    intrinsics: torch.Tensor
    points: torch.Tensor
    reported_cost: float
    iterations: int


@dataclasses.dataclass
class Window:
    wall_s: float
    answers: list
    counts: dict

    @property
    def iterations(self):
        return sum(a.iterations for a in self.answers)


def port_options(config: dict, traffic: dict):
    """The configuration's solver options as the port's BAOptions, run for
    the traffic's number of LM iterations."""
    s = dict(config["solver"])
    active = set(config["optimize_intrinsics"])
    return port_ba.BAOptions(
        optimize_intrinsics=tuple(i in active for i in range(10)),
        max_iterations=int(traffic["lm_iterations"]), **s)


class Cell:
    """One cell's set-up, window and check. `solve`, when given, replaces
    the port: solve(cell, extrinsics, points) -> Answer (the control and
    the planted faults use it)."""

    def __init__(self, config, traffic, seed, device="cuda", solve=None,
                 log=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.log = log or (lambda msg: None)
        self.scene = generator.make_scene(config, traffic, seed,
                                          self.device)
        self._sync()
        self.log("scene made")
        self.opts = port_options(config, traffic)
        sc = self.scene
        extr0, pts0 = generator.start(sc, traffic, seed, -1)
        prob = port_ba.BAProblem(
            extrinsics=extr0, intrinsics=sc.intrinsics, points=pts0,
            obs_cam=sc.obs_cam.to(torch.int32),
            obs_group=sc.obs_group.to(torch.int32),
            obs_pt=sc.obs_pt.to(torch.int32), obs_pix=sc.obs_pix,
            obs_mask=sc.obs_mask)
        prob = port_ba.pad_obs_to_multiple(prob, PLAN_BLOCK)
        self.kernels = (self.opts.pallas_matvec and
                        sc.intrinsics.shape[0] == 1)
        if self.kernels:
            prob = port_ba.add_pallas_matvec_plan(prob, block=PLAN_BLOCK)
        self.problem = prob
        # the window holds the port's problem and the truth the starts are
        # drawn around; the observations are made again for the judge
        self.scene = dataclasses.replace(
            sc, obs_cam=None, obs_group=None, obs_pt=None, obs_pix=None,
            obs_mask=None)
        self._full = None
        del sc, prob
        self.solve = solve or port_solve
        self._sync()
        self.log("problem prepared")
        # warm-up: one LM iteration at the cell's shapes
        self.solve(self, extr0, pts0, iterations=1)
        self._sync()
        self.log("warm-up done")

    def full_scene(self):
        """The whole scene, made again from the seed (the same draws give
        the same tensors), and kept."""
        if self._full is None:
            self._full = generator.make_scene(self.config, self.traffic,
                                              self.seed, self.device)
        return self._full

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def shapes(self) -> dict:
        """What the kernels' byte and operation counts need."""
        p = self.problem
        return {"M": p.obs_cam.shape[0], "Nc": p.extrinsics.shape[0],
                "Np": p.points.shape[0],
                "P": len(self.config["optimize_intrinsics"]),
                "matvec_bytes": 2 if self.opts.matvec_bf16 else 4}

    def window(self, seconds: float) -> Window:
        """Whole solves from fresh starts until `seconds` have passed; the
        answers are moved to the host as they come."""
        port_dispatch.reset_dispatch_counts()
        answers = []
        self._sync()
        t0 = time.perf_counter()
        while True:
            extr0, pts0 = generator.start(self.scene, self.traffic,
                                          self.seed, len(answers))
            answers.append(self.solve(self, extr0, pts0))
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        return Window(wall, answers, port_dispatch.dispatch_counts())

    def release(self):
        """Free the port's problem (the reference runs after)."""
        self.problem = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def path_check(self, win: Window):
        """(ok, message): the kernels ran for every Schur product and every
        LM iteration's blocks where one intrinsics group makes them
        eligible, and never otherwise."""
        c = win.counts
        n = c.get("schur_matvec", 0)
        got = {k: c.get(k, 0) for k in KERNELS}
        if n == 0:
            return False, f"no Schur products counted: {c}"
        if self.kernels:
            want = {"schur_pass1": n, "schur_pass2": n,
                    "ba_blocks": win.iterations if self.opts.pallas_blocks
                    else 0}
        else:
            want = {k: 0 for k in KERNELS}
        if got != want:
            return False, f"launches {got}, expected {want}"
        return True, f"launches {got} for {n} Schur products"

    def judge(self, win: Window):
        """(failed solves, {number: worst reading over the solves}) against
        the minimum the reference finds in float64. Every start of a run
        approaches the same minimum of the same observations, the one by
        the truth they were drawn around: the reference solves from the
        truth itself, where LM converges in a few steps and no step
        overshoots. A solve fails where a number with a limit in the
        configuration reads above it; the others are read and held to
        nothing."""
        scene = self.full_scene()
        obs = reference.Observations.of(scene)
        ropts = reference.Options.from_config(
            self.config, int(self.config["reference_iterations"]))
        ref = reference.solve(obs, scene.intrinsics, scene.extrinsics,
                              scene.points, ropts, log=self.log,
                              tol=REFERENCE_TOL)
        judge = compare.Judge(obs, ref, ropts.loss_scale)
        del ref
        self._sync()
        self.log("reference solved")
        limits = self.config["limits"]
        worst = {k: -float("inf") for k in compare.NUMBERS}
        failed = 0
        for n, a in enumerate(win.answers):
            nums = judge.numbers(a.extrinsics, a.intrinsics, a.points,
                                 a.reported_cost)
            self.log(f"solve {n}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in nums.items()))
            failed += any(not nums[k] <= limits[k] for k in limits)
            worst = {k: max(worst[k], nums[k]) for k in nums}
        return failed, worst


def port_solve(cell: Cell, extr0, pts0, iterations=None) -> Answer:
    """The port's solve of the cell's problem from this start."""
    opts = cell.opts
    if iterations is not None:
        opts = dataclasses.replace(opts, max_iterations=iterations)
    out, summary = port_ba.bundle_adjust(
        cell.problem._replace(extrinsics=extr0, points=pts0), opts)
    return Answer(out.extrinsics.cpu(), out.intrinsics.cpu(),
                  out.points.cpu(), float(summary.final_cost),
                  int(summary.num_iterations))


def reference_solve(dtype):
    """The reference in the port's place, computed in `dtype` (the
    lower-precision control)."""
    def solve(cell: Cell, extr0, pts0, iterations=None) -> Answer:
        scene = cell.full_scene()
        obs = reference.Observations.of(scene, dtype)
        n = iterations or int(cell.traffic["lm_iterations"])
        ropts = reference.Options.from_config(cell.config, n)
        extr, intr, pts = reference.solve(obs, scene.intrinsics, extr0,
                                          pts0, ropts, dtype=dtype)
        cost = compare.reported_cost(obs, extr, intr, pts, ropts.loss_scale)
        return Answer(extr.float().cpu(), intr.float().cpu(),
                      pts.float().cpu(), float(cost.to(dtype)), n)
    return solve


def _unchanged(cell: Cell, extr0, pts0, iterations=None) -> Answer:
    """A solve that returns its start (and its start's cost) unchanged."""
    out, summary = port_ba.bundle_adjust(
        cell.problem._replace(extrinsics=extr0, points=pts0),
        dataclasses.replace(cell.opts, max_iterations=0))
    return Answer(out.extrinsics.cpu(), out.intrinsics.cpu(),
                  out.points.cpu(), float(summary.final_cost),
                  iterations or cell.opts.max_iterations)


def _half_batch(cell: Cell, extr0, pts0, iterations=None) -> Answer:
    """A solve that leaves the second half of the observations out."""
    mask = cell.problem.obs_mask.clone()
    mask[mask.shape[0] // 2:] = False
    prob = cell.problem
    cell.problem = prob._replace(obs_mask=mask)
    try:
        return port_solve(cell, extr0, pts0, iterations)
    finally:
        cell.problem = prob


def _altered(cell: Cell, extr0, pts0, iterations=None) -> Answer:
    """A solve whose returned points are moved by 0.01 along x."""
    a = port_solve(cell, extr0, pts0, iterations)
    a.points[:, 0] += 0.01
    return a


# faults planted under the timed path, for the checks that `correct`
# comes out false (benchmark/tests, benchmark/tools/readings.py)
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}
