"""The synthetic problems the repo benchmarks.

`make_problem` reproduces `__graft_entry__._make_problem` of the JAX
package in numpy, with the same `default_rng(0)` draws: cameras on a
ring looking inward, points in a cube, `obs_per_pt` observations per
point from random cameras, pixels with 0.5 px noise, and a perturbed
starting state. With `perturb_seed` it also adds the perturbation of
scripts/bench_probe.py (seed 7 there): positions 0.05, rotations 0.005,
points 0.05. At (550, 140000, 4) this is the 1DSfM Notre-Dame scale:
550 cameras, 140k points, 560k observations.

`build_city_scene` reproduces `tests/test_large_scale.py::build_city_scene`
of the JAX package in numpy, with the same draws from the caller's
`np.random.Generator` in the same order: cameras on a 60-unit street
loop looking out at a ring of facades, pixels with noise, tracks of
length >= 3, and a view graph of each view's 10 successors with 0.3
degree rotation noise and a share of outlier edges. At 553 views and
14,000 points it is the 1DSfM Notre-Dame view count.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera import models as cm
from .math import rotation as rot
from .sfm.ba.bundle_adjustment import BAProblem
from .sfm.reconstruction import Reconstruction
from .sfm.view_graph import TwoViewInfo, ViewGraph
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


def build_city_scene(rng, n_views=200, n_pts=4000, noise_px=0.5,
                     outlier_edge_frac=0.05):
    """Cameras along a street loop looking at building facades. Returns
    (Reconstruction with unestimated views and tracks, ViewGraph, true
    extrinsics (n_views, 6)); all on the host."""
    focal = 800.0
    intr = np.zeros(10)
    intr[0] = focal
    intr[1] = 1.0
    intr[3] = 640.0
    intr[4] = 480.0

    def aa_of(R):
        return rot.rotation_matrix_to_angle_axis(torch.from_numpy(R)).numpy()

    extrs = np.zeros((n_views, 6))
    for v in range(n_views):
        s = v / n_views * 2 * np.pi
        c = np.array([30 * np.cos(s), 0.5 * np.sin(3 * s),
                      30 * np.sin(s)])
        # look outward from the loop centre
        z = np.array([np.cos(s), 0.0, np.sin(s)])
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        extrs[v, :3] = c
        extrs[v, 3:] = aa_of(np.stack([x, y, z]))

    # points on a ring of facades outside the camera loop
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = rng.uniform(38, 48, n_pts)
    pts = np.stack([rad * np.cos(ang), rng.uniform(-5, 8, n_pts),
                    rad * np.sin(ang)], -1)

    recon = Reconstruction()
    vids = [recon.add_view(f"v{v:04d}.jpg", group=0)
            for v in range(n_views)]
    for v in range(n_views):
        view = recon.views[vids[v]]
        view.camera.intrinsics = intr.copy()
        view.camera.image_width, view.camera.image_height = 1280, 960

    # observations: project; keep in-frustum
    obs = {}
    pts_t = torch.from_numpy(pts)
    intr_t = torch.from_numpy(intr)
    for v in range(n_views):
        with torch.no_grad():
            pix, depth = cm.project(
                cm.CameraModelType.PINHOLE,
                torch.from_numpy(extrs[v]).expand(n_pts, 6), intr_t, pts_t)
        pix = pix.numpy() + rng.normal(scale=noise_px, size=(n_pts, 2))
        d = depth.numpy()
        sel = (d > 3) & (d < 25) & (pix[:, 0] >= 0) & \
            (pix[:, 0] < 1280) & (pix[:, 1] >= 0) & (pix[:, 1] < 960)
        obs[v] = (np.nonzero(sel)[0], pix[sel])

    # tracks
    track_ids = {}
    for v in range(n_views):
        idxs, pix = obs[v]
        for k, p in zip(idxs, pix):
            track_ids.setdefault(k, []).append((v, p))
    for k, lst in track_ids.items():
        if len(lst) < 3:
            continue
        t = recon.add_track()
        for v, p in lst:
            recon.add_observation(vids[v], t, p)

    # view graph from ground truth + noise + outliers
    graph = ViewGraph()
    R_all = rot.angle_axis_to_rotation_matrix(
        torch.from_numpy(extrs[:, 3:])).numpy()
    seen = [set(obs[v][0].tolist()) for v in range(n_views)]
    for v1 in range(n_views):
        for dv in range(1, 11):
            v2 = (v1 + dv) % n_views
            common = len(seen[v1] & seen[v2])
            if common < 40:
                continue
            aa_rel = aa_of(R_all[v2] @ R_all[v1].T)
            d = R_all[v1] @ (extrs[v2, :3] - extrs[v1, :3])
            d /= np.linalg.norm(d)
            if rng.uniform() < outlier_edge_frac:
                aa_rel = rng.normal(size=3)
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
            else:
                naa = rng.normal(size=3)
                naa *= np.radians(0.3) / np.linalg.norm(naa)
                aa_rel = rot.multiply_rotations(
                    torch.from_numpy(naa),
                    torch.from_numpy(aa_rel)).numpy()
            info = TwoViewInfo(rotation_2=aa_rel, position_2=d,
                               num_verified_matches=common,
                               focal_length_1=focal,
                               focal_length_2=focal)
            graph.add_edge(vids[v1], vids[v2], info)
    return recon, graph, extrs
