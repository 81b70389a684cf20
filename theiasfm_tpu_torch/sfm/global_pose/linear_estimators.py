"""Linear global estimators (spectral / least-squares forms; port of
theiasfm_tpu/sfm/global_pose/linear_estimators.py).

ref: src/theia/sfm/global_pose_estimation/linear_rotation_estimator.{h,cc}
(Martinec-Pajdla linear rotation averaging via Spectra shift-invert
sparse eigensolve, linear_rotation_estimator.cc:44,173) and
nonlinear_rotation_estimator.{h,cc} (Ceres LS over pairwise rotation
errors).

The quadratic form sum_e ||R_j - R_ij R_i||_F^2 is assembled on the
host as a dense (3V, 3V) PSD matrix, as in the JAX module, whose
smallest eigenvectors come from one numpy eigh; the blocks are then
projected to SO(3) on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from ...math import rotation as rot
from ...utils.device import resolve_device
from .rotation_averaging import (RobustRotationOptions, _host_rotations,
                                 robust_rotation_averaging)


def linear_rotation_averaging(num_views: int, edges: np.ndarray,
                              rel_rotations: np.ndarray,
                              weights=None, dtype=torch.float32,
                              device="cuda") -> np.ndarray:
    """Martinec-Pajdla: minimize sum_e w_e ||R_j - R_ij R_i||_F^2 over
    unconstrained 3x3 blocks; solution = 3 smallest eigenvectors of the
    quadratic-form matrix; blocks projected to SO(3). Returns (V, 3)
    angle-axis world->camera."""
    dev = resolve_device(device)
    E = edges.shape[0]
    w = np.ones(E) if weights is None else np.asarray(weights, float)
    R_rel = _host_rotations(rel_rotations)
    V = num_views
    A = np.zeros((3 * V, 3 * V))
    eye = np.eye(3)
    for e in range(E):
        i, j = int(edges[e, 0]), int(edges[e, 1])
        Rij = R_rel[e]
        # residual B = R_j - R_ij R_i -> quadratic form contributions
        # [i,i] += Rij^T Rij = I; [j,j] += I; [i,j] -= Rij^T; [j,i] -= Rij
        A[3 * i:3 * i + 3, 3 * i:3 * i + 3] += w[e] * eye
        A[3 * j:3 * j + 3, 3 * j:3 * j + 3] += w[e] * eye
        A[3 * i:3 * i + 3, 3 * j:3 * j + 3] += -w[e] * Rij.T
        A[3 * j:3 * j + 3, 3 * i:3 * i + 3] += -w[e] * Rij
    vals, vecs = np.linalg.eigh(A)
    basis = vecs[:, :3]  # (3V, 3)
    Rs = basis.reshape(V, 3, 3)
    # fix the global gauge: make block 0 a proper rotation, align others
    R0 = Rs[0]
    M = torch.as_tensor(Rs @ np.linalg.inv(R0 + 1e-12 * np.eye(3)),
                        device=dev).to(dtype)
    # project each block onto SO(3)
    aa = rot.rotation_matrix_to_angle_axis(rot.project_to_rotation_matrix(M))
    return aa.cpu().numpy().astype(np.float64)


def nonlinear_rotation_averaging(init_orientations: np.ndarray,
                                 edges: np.ndarray,
                                 rel_rotations: np.ndarray,
                                 dtype=torch.float32,
                                 device="cuda") -> np.ndarray:
    """Plain nonlinear least squares over pairwise rotation errors (ref
    NonlinearRotationEstimator): the robust engine with (near-)uniform
    weights."""
    opts = RobustRotationOptions(l1_iterations=0, irls_iterations=15,
                                 sigma_degrees=60.0)
    return robust_rotation_averaging(init_orientations, edges,
                                     rel_rotations, opts, dtype=dtype,
                                     device=device)
