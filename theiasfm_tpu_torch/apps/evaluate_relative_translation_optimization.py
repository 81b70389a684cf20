"""Evaluate pairwise relative-translation optimization on a 1DSfM
dataset against ground truth (port of
apps/evaluate_relative_translation_optimization.py).

ref: applications/evaluate_relative_translation_optimization.cc — set
the ground-truth global rotations (from gt_bundle.out), run the
known-rotation pairwise translation refinement (global pipeline step 5)
on every view-graph edge, and report the angular error of the relative
translation directions before and after. The refinement runs on
`--device` (the card by default; --device cpu runs on the CPU), in
float64 as the global pipeline runs it; the errors are computed in
float64 on the host.

Usage:
  python -m theiasfm_tpu_torch.apps.\\
evaluate_relative_translation_optimization \\
      --1dsfm_dataset_directory Notre_Dame/
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io._rotation import angle_axis_to_rotation_matrix
from ..sfm.pipeline.global_pipeline import _refine_relative_translations
from ..utils.device import resolve_device
from .verify_1dsfm_input import _print_histogram, read_dataset_and_truth


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--1dsfm_dataset_directory", dest="dataset",
                   required=True)
    p.add_argument("--max_correspondences_per_pair", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device of the refinement (cuda by "
                        "default; cpu runs on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    recon, graph, gt_by_name = read_dataset_and_truth(args.dataset)

    # keep only edges where both endpoints have ground truth
    vids = [v for v in graph.view_ids()
            if recon.views[v].name in gt_by_name]
    vid_idx = {v: i for i, v in enumerate(vids)}
    orientations = np.stack([
        gt_by_name[recon.views[v].name].camera.extrinsics[3:6]
        for v in vids])
    # adopt gt poses on the working reconstruction for correspondences
    for v in vids:
        recon.views[v].camera.extrinsics[:] = \
            gt_by_name[recon.views[v].name].camera.extrinsics
        recon.views[v].is_estimated = True

    edges, rel_pos = [], []
    for (v1, v2), info in graph.edges().items():
        if v1 in vid_idx and v2 in vid_idx:
            edges.append((v1, v2))
            rel_pos.append(np.asarray(info.position_2, float))
    edges = np.asarray(edges, int)
    rel_pos = np.stack(rel_pos)

    def angular_errors(positions):
        errs = []
        for (v1, v2), t in zip(edges, positions):
            g1 = gt_by_name[recon.views[int(v1)].name].camera
            g2 = gt_by_name[recon.views[int(v2)].name].camera
            R1 = angle_axis_to_rotation_matrix(g1.extrinsics[3:6])
            t_gt = R1 @ (g2.extrinsics[:3] - g1.extrinsics[:3])
            n = np.linalg.norm(t_gt)
            if n < 1e-12:
                continue
            cos = float(np.dot(t / max(np.linalg.norm(t), 1e-12),
                               t_gt / n))
            errs.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
        return errs

    before = angular_errors(rel_pos)
    refined = _refine_relative_translations(
        recon, vid_idx, orientations, edges, rel_pos,
        max_corrs=args.max_correspondences_per_pair, device=device)
    after = angular_errors(refined)

    print(f"edges evaluated: {len(edges)}")
    _print_histogram("translation angular error BEFORE", before)
    _print_histogram("translation angular error AFTER", after)
    return 0


if __name__ == "__main__":
    sys.exit(main())
