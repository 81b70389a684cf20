"""Evaluate matched two-view geometries against a ground-truth
reconstruction (port of apps/compute_matching_relative_pose_errors.py;
host only).

ref: applications/compute_matching_relative_pose_errors.cc — for each
ImagePairMatch in a features/matches database, compare its TwoViewInfo
relative rotation and translation direction to the poses of the same
views in a ground-truth reconstruction, printing error histograms.
Rotations are computed in float64 on the host (io/_rotation.py).

Usage:
  python -m theiasfm_tpu_torch.apps.compute_matching_relative_pose_errors \\
      --matches_dir db/ --reconstruction gt.npz
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io._rotation import angle_axis_to_rotation_matrix
from ..matching.database import DiskFeaturesAndMatchesDatabase
from .compare_reconstructions import load_any
from .verify_1dsfm_input import _print_histogram


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--matches_dir", required=True,
                   help="DiskFeaturesAndMatchesDatabase directory")
    p.add_argument("--reconstruction", required=True,
                   help="ground-truth reconstruction")
    args = p.parse_args(argv)

    gt = load_any(args.reconstruction)
    gt_by_name = {}
    for v in gt.views.values():
        if not v.is_estimated:
            continue
        R = angle_axis_to_rotation_matrix(v.camera.extrinsics[3:6])
        gt_by_name[v.name] = (R, v.camera.extrinsics[:3].copy())

    db = DiskFeaturesAndMatchesDatabase(args.matches_dir)
    rot_errs, trans_errs = [], []
    for (n1, n2) in db.image_pairs_of_matches():
        if n1 not in gt_by_name or n2 not in gt_by_name:
            continue
        m = db.get_match(n1, n2)
        info = m.twoview_info
        R1, c1 = gt_by_name[n1]
        R2, c2 = gt_by_name[n2]
        R_rel = angle_axis_to_rotation_matrix(info.rotation_2)
        loop = R_rel.T @ (R2 @ R1.T)
        rot_errs.append(np.degrees(np.arccos(
            np.clip((np.trace(loop) - 1) / 2, -1, 1))))
        t_gt = R1 @ (c2 - c1)
        n = np.linalg.norm(t_gt)
        if n > 1e-12:
            cos = float(np.dot(np.asarray(info.position_2, float),
                               t_gt / n))
            trans_errs.append(np.degrees(np.arccos(
                np.clip(cos, -1.0, 1.0))))

    print(f"matched pairs with ground truth: {len(rot_errs)}")
    _print_histogram("relative rotation error", rot_errs)
    _print_histogram("relative translation angular error", trans_errs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
