"""The synthetic bundle-adjustment problem the repo benchmarks.

`make_problem` reproduces `__graft_entry__._make_problem` of the JAX
package in numpy, with the same `default_rng(0)` draws: cameras on a
ring looking inward, points in a cube, `obs_per_pt` observations per
point from random cameras, pixels with 0.5 px noise, and a perturbed
starting state. With `perturb_seed` it also adds the perturbation of
scripts/bench_probe.py (seed 7 there): positions 0.05, rotations 0.005,
points 0.05. At (550, 140000, 4) this is the 1DSfM Notre-Dame scale:
550 cameras, 140k points, 560k observations.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import models as cm
from .math import rotation as rot
from .sfm.ba.bundle_adjustment import BAProblem
from .utils.device import resolve_device


def make_problem(n_cams=32, n_pts=1024, obs_per_pt=4,
                 dtype=torch.float32, device="cuda",
                 perturb_seed=None) -> BAProblem:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    extr = []
    for v in range(n_cams):
        ang = 2 * np.pi * v / n_cams * 0.25
        c = np.array([12 * np.sin(ang), 0.2 * rng.normal(),
                      -12 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        aa = rot.rotation_matrix_to_angle_axis(torch.from_numpy(R)).numpy()
        extr.append(np.concatenate([c, aa]))
    extr = np.stack(extr)
    pts = rng.uniform(-3, 3, size=(n_pts, 3))
    intr = np.zeros((1, 10))
    intr[0, 0] = 700.0
    intr[0, 1] = 1.0
    intr[0, 3:5] = [500.0, 400.0]

    obs_cam = rng.integers(0, n_cams, size=n_pts * obs_per_pt)
    obs_pt = np.repeat(np.arange(n_pts), obs_per_pt)
    with torch.no_grad():
        pix, depth = cm.project(
            cm.CameraModelType.PINHOLE,
            torch.as_tensor(extr[obs_cam], dtype=dtype),
            torch.as_tensor(intr[0], dtype=dtype),
            torch.as_tensor(pts[obs_pt], dtype=dtype))
    pix = pix.numpy() + rng.normal(scale=0.5, size=tuple(pix.shape))
    mask = depth.numpy() > 0.1

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    extr0 = (extr + rng.normal(scale=0.01, size=extr.shape)).astype(np_dtype)
    pts0 = (pts + rng.normal(scale=0.02, size=pts.shape)).astype(np_dtype)
    if perturb_seed is not None:
        prng = np.random.default_rng(perturb_seed)
        extr0 = extr0.astype(np.float64)
        extr0[:, :3] += prng.normal(scale=0.05, size=(n_cams, 3))
        extr0[:, 3:] += prng.normal(scale=0.005, size=(n_cams, 3))
        extr0 = extr0.astype(np_dtype)
        pts0 = (pts0 + prng.normal(scale=0.05, size=pts0.shape)
                ).astype(np_dtype)

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return BAProblem(
        extrinsics=t(extr0),
        intrinsics=t(intr),
        points=t(pts0),
        obs_cam=t(obs_cam, torch.int32),
        obs_group=torch.zeros(len(obs_cam), dtype=torch.int32,
                              device=device),
        obs_pt=t(obs_pt, torch.int32),
        obs_pix=t(pix),
        obs_mask=t(mask, torch.bool),
    )
