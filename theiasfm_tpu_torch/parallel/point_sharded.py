"""Point-sharded multi-device bundle adjustment (port of
theiasfm_tpu/parallel/point_sharded.py).

The observation-sharded solver (mesh.py) replicates the points, so every
point-block reduction is an (Np, ...) all-reduce per CG iteration. This
one shards the points and their observations together:

  * points are split into contiguous ranges (observations are sorted by
    point, so each rank owns a contiguous slice of both), chosen to
    balance the observations per rank;
  * all point-block math (Hpp, its inverse, the point gradients, the
    back-substitution, the inner iterations) is rank-local;
  * only the camera and group reductions and the cost cross the mesh:
    O(Nc * 36 + Ng * P^2) values per matvec, whatever the scene's size.

With `BAOptions.pallas_matvec` and one intrinsics group each rank runs
S·v through the Schur-matvec kernels (sfm/ba/fused_matvec.py) on its own
observations, and the kernels' camera-side outputs are all-reduced
(bundle_adjustment.py). The LM loop runs on every rank on all-reduced
costs, so its decisions agree across ranks. The points come back by one
all-reduce: each rank writes its range into a zero (Np, 3) tensor, and
the sum of one value and zeros is exact.

A 2-D ("dcn", "ici") mesh shards the points over the product of its
axes, and the reductions run within a row, then across rows.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..sfm.ba import BAOptions, BAProblem, BASummary, bundle_adjust
from ..sfm.ba import fused_matvec as fm
from ..utils import collectives
from ..utils.padding import next_bucket
from .mesh import Mesh

__all__ = ["partition_problem_by_point", "point_sharded_bundle_adjust"]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def partition_problem_by_point(prob: BAProblem, n_dev: int,
                               pallas_block: int = 0):
    """Split a point-sorted BAProblem into n_dev shards (numpy, the JAX
    function's arrays bit for bit).

    Returns (shards, meta): shards holds the stacked arrays, D * M_loc
    observations and D * Np_loc points; meta the per-shard point ranges
    (pt_start), Np_loc and n_dev for reassembly. Padding observations
    are masked and point at their shard's last real point; padding
    points carry point_mask False. pallas_block > 0 rounds M_loc up to
    a multiple of it and adds each shard's fused-matvec plan (pmv_*)
    with one point window for all shards."""
    obs_pt = _host(prob.obs_pt)
    M = obs_pt.shape[0]
    Np = prob.points.shape[0]
    if np.any(np.diff(obs_pt) < 0):
        raise ValueError("observations must be sorted by point")

    counts = np.bincount(obs_pt, minlength=Np)
    cum = np.cumsum(counts)
    targets = (np.arange(1, n_dev) * M) / n_dev
    bounds = np.searchsorted(cum, targets, side="left") + 1
    bounds = np.clip(bounds, 1, Np)
    pt_start = np.concatenate([[0], bounds, [Np]]).astype(np.int64)
    # monotone boundaries on degenerate tiny problems
    pt_start = np.maximum.accumulate(pt_start)
    obs_start = np.concatenate(
        [[0], cum[pt_start[1:-1] - 1], [M]]).astype(np.int64)

    M_loc = next_bucket(int(np.max(np.diff(obs_start))), 64)
    Np_loc = next_bucket(int(np.max(np.diff(pt_start))), 16)
    if pallas_block:
        M_loc = next_bucket(M_loc, pallas_block)

    D = n_dev
    src = {k: _host(getattr(prob, k)) for k in
           ("obs_cam", "obs_group", "obs_pix", "obs_mask", "points")}
    dtype = src["points"].dtype
    obs_cam = np.zeros((D, M_loc), np.int32)
    obs_group = np.zeros((D, M_loc), np.int32)
    obs_pt_loc = np.zeros((D, M_loc), np.int32)
    obs_pix = np.zeros((D, M_loc, 2), dtype)
    obs_mask = np.zeros((D, M_loc), bool)
    points = np.zeros((D, Np_loc, 3), dtype)
    point_mask = np.zeros((D, Np_loc), bool)
    src_pmask = (_host(prob.point_mask) if prob.point_mask is not None
                 else np.ones(Np, bool))
    for d in range(D):
        o0, o1 = obs_start[d], obs_start[d + 1]
        p0, p1 = pt_start[d], pt_start[d + 1]
        m, n = o1 - o0, p1 - p0
        obs_cam[d, :m] = src["obs_cam"][o0:o1]
        obs_group[d, :m] = src["obs_group"][o0:o1]
        obs_pt_loc[d, :m] = obs_pt[o0:o1] - p0
        # padding observations point at the shard's last real point (the
        # masked jacobians make the target irrelevant), which keeps the
        # plan's point window tight on point-imbalanced shards
        obs_pt_loc[d, m:] = max(int(n) - 1, 0)
        obs_pix[d, :m] = src["obs_pix"][o0:o1]
        obs_mask[d, :m] = src["obs_mask"][o0:o1]
        points[d, :n] = src["points"][p0:p1]
        point_mask[d, :n] = src_pmask[p0:p1]

    shards = dict(
        obs_cam=obs_cam.reshape(-1),
        obs_group=obs_group.reshape(-1),
        obs_pt=obs_pt_loc.reshape(-1),
        obs_pix=obs_pix.reshape(D * M_loc, 2),
        obs_mask=obs_mask.reshape(-1),
        points=points.reshape(D * Np_loc, 3),
        point_mask=point_mask.reshape(-1),
    )
    if pallas_block:
        Nc = prob.extrinsics.shape[0]
        # each shard's natural window first, then every plan rebuilt
        # with the largest, so the shards' plans have one shape
        plans = [fm.MatvecPlan(obs_cam[d], obs_pt_loc[d], Nc, Np_loc,
                               block=pallas_block) for d in range(D)]
        W = max(p.W for p in plans)
        plans = [fm.MatvecPlan(obs_cam[d], obs_pt_loc[d], Nc, Np_loc,
                               block=pallas_block, force_window=W)
                 for d in range(D)]
        shards["pmv_cam_tiles"] = np.concatenate(
            [p.cam_tiles for p in plans]).astype(np.int32)
        shards["pmv_lpt_tiles"] = np.concatenate(
            [p.local_pt for p in plans]).astype(np.int32)
        shards["pmv_p0"] = np.concatenate(
            [p.tile_p0 for p in plans]).astype(np.int32)
        shards["pmv_window"] = np.zeros((W,), np.int8)
    meta = dict(pt_start=pt_start, Np_loc=Np_loc, n_dev=D)
    return shards, meta


def point_sharded_bundle_adjust(
        prob: BAProblem, opts: BAOptions, mesh: Mesh,
        axis_name="obs") -> Tuple[BAProblem, BASummary]:
    """Bundle adjust with points and their observations sharded over
    `mesh`; every rank calls it with the same point-sorted `prob`.

    Cameras and intrinsics are replicated. Returns (the input problem
    with the solved parameters, on the mesh's device; BASummary), the
    same on every rank. For a 2-D mesh pass its axes, e.g.
    axis_name=("dcn", "ici")."""
    mesh.check_axes(axis_name)
    D, d = mesh.size, mesh.rank
    use_kernels = opts.pallas_matvec and prob.intrinsics.shape[0] == 1
    shards, meta = partition_problem_by_point(
        prob, D, pallas_block=1024 if use_kernels else 0)
    M_loc = shards["obs_cam"].shape[0] // D
    Np_loc = meta["Np_loc"]
    dev = mesh.device

    def mine(name, n):
        return torch.as_tensor(shards[name][d * n:(d + 1) * n], device=dev)

    cam_mask = (prob.cam_mask if prob.cam_mask is not None else
                torch.ones(prob.extrinsics.shape[0], dtype=torch.bool))
    local = BAProblem(
        extrinsics=prob.extrinsics.to(dev),
        intrinsics=prob.intrinsics.to(dev),
        points=mine("points", Np_loc),
        obs_cam=mine("obs_cam", M_loc), obs_group=mine("obs_group", M_loc),
        obs_pt=mine("obs_pt", M_loc), obs_pix=mine("obs_pix", M_loc),
        obs_mask=mine("obs_mask", M_loc), cam_mask=cam_mask.to(dev),
        point_mask=mine("point_mask", Np_loc))
    if use_kernels:
        # this rank's fused-matvec plan: its kernels sum its own
        # observations
        G = shards["pmv_p0"].shape[0] // D
        local = local._replace(
            pmv_cam_tiles=mine("pmv_cam_tiles", G),
            pmv_lpt_tiles=mine("pmv_lpt_tiles", G),
            pmv_p0=mine("pmv_p0", G),
            pmv_window=torch.as_tensor(shards["pmv_window"], device=dev))
    run_opts = dataclasses.replace(opts, axis_name=axis_name,
                                   point_indices_sorted=True)
    p0, p1 = (int(x) for x in meta["pt_start"][d:d + 2])
    with mesh.bind():
        out, summary = bundle_adjust(local, run_opts)
        # each rank's range into zeros; the sum is the global array
        points = torch.zeros_like(prob.points, device=dev)
        points[p0:p1] = out.points[:p1 - p0]
        points = collectives.psum(points, axis_name)
    return prob._replace(extrinsics=out.extrinsics,
                         intrinsics=out.intrinsics, points=points), summary
