"""One small sharded run of every multi-device solver (the port's
counterpart of __graft_entry__.dryrun_multichip).

    python -m theiasfm_tpu_torch.parallel.dryrun 8 --device cpu

starts n ranks (threads on the CPU, spawned processes on the card;
parallel/ranks.py) and makes the JAX dry run's five checks with its
bounds: the observation-sharded BA finite; the point-sharded BA within
1e-3 of it; the point-sharded BA on a 2 x n/2 ("dcn", "ici") mesh
within 1e-3; the point-sharded BA through the fused-matvec kernels in
float32 within 1e-2; the edge-sharded rotation averaging and LUD
positions finite. Every rank must return the same readings.

JAX runs the edge solvers' default schedules inside compiled loops;
eagerly each CG iteration is an all-reduce (the LUD polish's 300 x 40
are some 13,500 a rank, minutes over gloo on a CPU box), so the dry run
runs cut schedules (ROTATION_OPTS, POSITION_OPTS): its check, as JAX's,
is that the results are finite. tests/test_torch_parallel_edges.py
holds the solvers to JAX's at its tests' schedules.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..bench_problem import make_problem
from ..math import rotation as rot
from ..sfm.ba import BAOptions
from ..sfm.global_pose import (PositionEstimatorOptions,
                               RobustRotationOptions, orientations_from_mst)
from ..utils import dispatch_counts
from .edge_sharded import (estimate_positions_sharded,
                           rotation_averaging_sharded)
from .mesh import sharded_bundle_adjust
from .point_sharded import point_sharded_bundle_adjust
from .ranks import run_ranks

__all__ = ["dryrun_multichip"]

ROTATION_OPTS = RobustRotationOptions(l1_iterations=2, irls_iterations=3,
                                      cg_iterations=20)
POSITION_OPTS = PositionEstimatorOptions(max_iterations=10)


def _edge_graph(V=16, seed=11):
    """The JAX dry run's 16-view graph: ground-truth orientations and
    positions, edges to the next three views, exact relative rotations
    and directions."""
    rng = np.random.default_rng(seed)
    aa_gt = rng.normal(scale=0.2, size=(V, 3))
    edges = np.asarray([(i, j) for i in range(V)
                        for j in range(i + 1, min(i + 4, V))])
    R = rot.angle_axis_to_rotation_matrix(torch.from_numpy(aa_gt)).numpy()
    R_rel = np.einsum("eij,ekj->eik", R[edges[:, 1]], R[edges[:, 0]])
    rel_aa = rot.rotation_matrix_to_angle_axis(
        torch.from_numpy(R_rel)).numpy()
    pos_gt = rng.normal(size=(V, 3)) * 3.0
    d = pos_gt[edges[:, 1]] - pos_gt[edges[:, 0]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rel_pos = np.einsum("eij,ej->ei", R[edges[:, 0]], d)
    return aa_gt, edges, rel_aa, rel_pos


def _dryrun_rank(ranks):
    """One rank's part: every solver on the dry run's inputs; returns the
    readings (host values)."""
    n = ranks.size
    prob = make_problem(n_cams=8, n_pts=64, obs_per_pt=3,
                        dtype=torch.float32, device=ranks.device)
    opts = BAOptions(max_iterations=2, cg_iterations=5, loss="huber",
                     loss_scale=2.0)
    out = {}
    mesh = ranks.mesh("obs")
    _, s = sharded_bundle_adjust(prob, opts, mesh)
    out["obs"] = (float(s.final_cost), s.num_iterations)
    _, s = point_sharded_bundle_adjust(prob, opts, mesh)
    out["point"] = (float(s.final_cost), s.num_iterations)
    if n % 2 == 0:
        mesh2 = ranks.mesh(("dcn", "ici"), (2, n // 2))
        _, s = point_sharded_bundle_adjust(prob, opts, mesh2,
                                           axis_name=("dcn", "ici"))
        out["dcn_ici"] = (float(s.final_cost), s.num_iterations)
    before = dict(dispatch_counts())
    _, s = point_sharded_bundle_adjust(
        prob, dataclasses.replace(opts, pallas_matvec=True), mesh)
    launches = {k: dispatch_counts().get(k, 0) - before.get(k, 0)
                for k in ("schur_pass1", "schur_pass2")}
    out["kernels"] = (float(s.final_cost), s.num_iterations, launches)

    aa_gt, edges, rel_aa, rel_pos = _edge_graph()
    w = np.ones(len(edges))
    init = orientations_from_mst(aa_gt.shape[0], edges, rel_aa, w)
    mesh_e = ranks.mesh("edges")
    out["orientations"] = rotation_averaging_sharded(
        init, edges, rel_aa, mesh_e, opts=ROTATION_OPTS)
    out["positions"] = estimate_positions_sharded(
        aa_gt, edges, rel_pos, mesh_e, edge_weights=w, opts=POSITION_OPTS)
    return out


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> dict:
    """Run the dry run on n_devices ranks; raises if a rank fails or a
    check misses. Returns rank 0's readings."""
    got = run_ranks(_dryrun_rank, n_devices, device=device,
                    timeout=timeout)
    first = got[0]
    for r, other in enumerate(got[1:], 1):
        for k, v in first.items():
            same = (np.array_equal(v, other[k]) if isinstance(v, np.ndarray)
                    else v == other[k])
            _check(same, f"rank {r} read {k} = {other[k]}, rank 0 {v}")
    final = first["obs"][0]
    _check(np.isfinite(final), f"observation-sharded cost {final}")
    print(f"dryrun_multichip({n_devices}): final_cost={final:.4g}, "
          f"iters={first['obs'][1]}")

    def near(key, tol, what):
        c = first[key][0]
        _check(np.isfinite(c) and abs(c - final) <= tol * max(abs(final),
                                                              1.0),
               f"{what} cost {c} against {final} (tol {tol})")
        print(f"dryrun_multichip({n_devices}) {what}: final_cost={c:.4g}")

    near("point", 1e-3, "point-sharded")
    if "dcn_ici" in first:
        near("dcn_ici", 1e-3, f"2x{n_devices // 2} dcn*ici")
    near("kernels", 1e-2, "point-sharded+kernels")
    if torch.device(device).type == "cuda":
        launches = first["kernels"][2]
        _check(all(launches[k] > 0 for k in launches),
               f"the kernels did not launch: {launches}")
    _check(np.all(np.isfinite(first["orientations"])) and
           np.all(np.isfinite(first["positions"])),
           "edge-sharded result not finite")
    print(f"dryrun_multichip({n_devices}) edge-sharded rotation+LUD: "
          f"V={first['orientations'].shape[0]} ok")
    return first


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
