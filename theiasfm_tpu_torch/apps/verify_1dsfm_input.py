"""Verify a 1DSfM dataset: compare the epipolar-graph relative poses
against the dataset's ground-truth bundler reconstruction (port of
apps/verify_1dsfm_input.py; host only).

ref: applications/verify_1dsfm_input.cc — for every view-graph edge,
measure (a) the relative rotation error in degrees against
R_2 R_1^T from the ground truth and (b) the angular error of the
relative translation direction, and print error histograms. Rotations
are computed in float64 on the host (io/_rotation.py).

Usage:
  python -m theiasfm_tpu_torch.apps.verify_1dsfm_input \\
      --1dsfm_dataset_directory Notre_Dame/
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io import read_1dsfm, read_bundler
from ..io._rotation import angle_axis_to_rotation_matrix

HIST_BINS = [2, 5, 10, 15, 25, 50, 90, 135, 180]


def _print_histogram(name, errors_deg):
    errors_deg = np.asarray(errors_deg)
    print(f"{name}: n={len(errors_deg)} mean={errors_deg.mean():.2f} "
          f"median={np.median(errors_deg):.2f} deg")
    lo = 0.0
    for hi in HIST_BINS:
        n = int(((errors_deg >= lo) & (errors_deg < hi)).sum())
        print(f"  [{lo:>5.1f}, {hi:>5.1f}) deg: {n}")
        lo = hi


def read_dataset_and_truth(dataset):
    """The dataset's (Reconstruction, ViewGraph) and its ground-truth
    views by name (gt_bundle.out with list.txt, estimated views only)."""
    recon, graph = read_1dsfm(dataset)
    gt_recon = read_bundler(os.path.join(dataset, "list.txt"),
                            os.path.join(dataset, "gt_bundle.out"))
    gt_by_name = {v.name: v for v in gt_recon.views.values()
                  if v.is_estimated}
    return recon, graph, gt_by_name


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--1dsfm_dataset_directory", dest="dataset",
                   required=True)
    args = p.parse_args(argv)

    recon, graph, gt_by_name = read_dataset_and_truth(args.dataset)

    # ground-truth world-to-camera rotations/positions, matched by name
    # (ref verify_1dsfm_input.cc:90-117 — ids can differ between the
    # epipolar-graph reconstruction and the gt bundler file)
    gt = {}
    for vid, view in recon.views.items():
        gt_view = gt_by_name.get(view.name)
        if gt_view is None:
            continue
        R = angle_axis_to_rotation_matrix(gt_view.camera.extrinsics[3:6])
        gt[vid] = (R, gt_view.camera.extrinsics[:3].copy())

    rot_errs, trans_errs = [], []
    for (v1, v2), info in graph.edges().items():
        if v1 not in gt or v2 not in gt:
            continue
        R1, c1 = gt[v1]
        R2, c2 = gt[v2]
        R_rel = angle_axis_to_rotation_matrix(info.rotation_2)
        loop = R_rel.T @ (R2 @ R1.T)
        ang = np.degrees(np.arccos(
            np.clip((np.trace(loop) - 1) / 2, -1, 1)))
        rot_errs.append(ang)

        t_gt = R1 @ (c2 - c1)
        n = np.linalg.norm(t_gt)
        if n > 1e-12:
            t_gt = t_gt / n
            cos = float(np.dot(np.asarray(info.position_2, float), t_gt))
            trans_errs.append(np.degrees(np.arccos(
                np.clip(cos, -1.0, 1.0))))

    print(f"dataset: {args.dataset}")
    print(f"views: {len(recon.views)} (gt poses: {len(gt)}), "
          f"edges: {graph.num_edges()}")
    _print_histogram("relative rotation error", rot_errs)
    _print_histogram("relative translation angular error", trans_errs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
