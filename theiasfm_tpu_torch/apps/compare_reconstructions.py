"""Compare two reconstructions by robustly aligning common cameras (port
of apps/compare_reconstructions.py; host only).

ref: applications/compare_reconstructions.cc — the evaluation tool
behind the published accuracy tables (BASELINE.md): aligns via robust
similarity on common camera positions, reports rotation/position error
distributions. Rotations are computed in float64 on the host
(io/_rotation.py). `--robust_alignment_threshold` is parsed and unused,
as in the JAX CLI: the alignment's inlier threshold is its own.

Usage:
  python -m theiasfm_tpu_torch.apps.compare_reconstructions \\
      --reference_reconstruction gt.npz --reconstruction_to_align model.bin
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import read_reconstruction, read_theia_reconstruction
from ..io._rotation import angle_axis_to_rotation_matrix
from ..sfm.transformation import align_reconstructions_robust


def load_any(path):
    """An .npz (native) reconstruction, else a Theia .bin."""
    if path.endswith(".npz"):
        return read_reconstruction(path)
    return read_theia_reconstruction(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference_reconstruction", required=True)
    p.add_argument("--reconstruction_to_align", required=True)
    p.add_argument("--robust_alignment_threshold", type=float,
                   default=0.0)
    args = p.parse_args(argv)

    ref = load_any(args.reference_reconstruction)
    est = load_any(args.reconstruction_to_align)

    common = []
    for vid, v in est.views.items():
        if not v.is_estimated:
            continue
        rvid = ref.view_id_from_name(v.name)
        if rvid == 2 ** 32 - 1:
            continue
        rv = ref.view(rvid)
        if rv.is_estimated:
            common.append((v, rv))
    if len(common) < 3:
        print("insufficient common cameras")
        return 1

    est_pos = np.stack([v.camera.position for v, _ in common])
    ref_pos = np.stack([rv.camera.position for _, rv in common])
    s, R, t = align_reconstructions_robust(est_pos, ref_pos)
    aligned = s * est_pos @ R.T + t
    pos_err = np.linalg.norm(aligned - ref_pos, axis=1)

    rot_err = []
    for v, rv in common:
        R_est = angle_axis_to_rotation_matrix(v.camera.extrinsics[3:6])
        R_ref = angle_axis_to_rotation_matrix(rv.camera.extrinsics[3:6])
        E = R_est @ R.T @ R_ref.T
        cos = np.clip((np.trace(E) - 1) / 2, -1, 1)
        rot_err.append(np.degrees(np.arccos(cos)))
    rot_err = np.asarray(rot_err)

    print(f"common cameras: {len(common)}")
    print(f"position error (units of reference): "
          f"median {np.median(pos_err):.6f}  mean {pos_err.mean():.6f}  "
          f"max {pos_err.max():.6f}")
    print(f"rotation error (deg): median {np.median(rot_err):.4f}  "
          f"mean {rot_err.mean():.4f}  max {rot_err.max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
