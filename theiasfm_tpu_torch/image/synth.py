"""Synthetic multi-view scene renderer for end-to-end benchmarks (copy
of theiasfm_tpu/image/synth.py, which is numpy only).

Renders N DISTINCT views of a 3D scene made of textured planes at
different depths, so the from-pixels pipeline (SIFT -> matching ->
verification -> reconstruction) sees genuine parallax — unlike
replicating one image, which creates duplicate pairs whose
rotation-only geometry poisons seed-pair selection (the round-3
failure mode; see CountHomographyInliers wiring in
sfm/pipeline/geometric_verification.py).

The reference has no synthetic *image* generator (its synthetic tests
start from projected 3D points, sfm/pose/test_util.h:44-77); this
extends the same idea one level down to pixels so e2e throughput can
be benched at any N without shipping datasets.

Pure numpy: per-plane inverse-homography bilinear warps composited by
depth. A plane with corner P0 and edge vectors U, V maps texture
coords (u, v) to pixels via H = K [R@U, R@V, R@P0 + t].
"""
from __future__ import annotations

import numpy as np

__all__ = ["render_synthetic_views"]


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """World->camera rotation for a camera at `eye` looking at `target`.
    Returns R with x_cam = R @ (X - eye)."""
    z = np.asarray(target, float) - np.asarray(eye, float)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, float), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z])


def _render_view(K, R, t, planes, texture, h, w):
    """Inverse-warp each textured plane and composite nearest-depth."""
    th, tw = texture.shape[:2]
    out = np.zeros((h, w), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, float)], -1)

    for P0, U, V, (tu0, tv0, tu1, tv1) in planes:
        H = K @ np.stack([R @ U, R @ V, R @ P0 + t], axis=1)
        try:
            Hinv = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            continue
        uvw = pix @ Hinv.T
        wv = uvw[..., 2]
        safe = np.where(np.abs(wv) < 1e-12, 1e-12, wv)
        u = uvw[..., 0] / safe
        v = uvw[..., 1] / safe
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        # depth of the plane point under this pixel
        X = (P0[None, None] + u[..., None] * U[None, None] +
             v[..., None] * V[None, None])
        depth = (X @ R.T + t)[..., 2]
        visible = inside & (depth > 1e-6) & (depth < zbuf)
        if not visible.any():
            continue
        # bilinear sample the texture crop
        tu = tu0 + u * (tu1 - tu0)
        tv = tv0 + v * (tv1 - tv0)
        fx = np.clip(tu * (tw - 1), 0, tw - 1.001)
        fy = np.clip(tv * (th - 1), 0, th - 1.001)
        x0 = fx.astype(int)
        y0 = fy.astype(int)
        ax = fx - x0
        ay = fy - y0
        val = ((1 - ax) * (1 - ay) * texture[y0, x0] +
               ax * (1 - ay) * texture[y0, x0 + 1] +
               (1 - ax) * ay * texture[y0 + 1, x0] +
               ax * ay * texture[y0 + 1, x0 + 1])
        out[visible] = val[visible]
        zbuf[visible] = depth[visible]
    return out


def render_synthetic_views(texture: np.ndarray, n_views: int,
                           image_size=(640, 480), focal: float = 600.0,
                           n_planes: int = 5, seed: int = 0,
                           baseline: float = 2.5):
    """Render n_views grayscale images of a multi-plane 3D scene.

    texture: (H, W) float or uint8 source image supplying the planes'
    appearance (each plane shows a random crop). Cameras sweep an arc
    of total length `baseline` looking at the scene center.

    Returns (images, cameras): images list of (h, w) float32 in [0,1];
    cameras list of dicts with K (3,3), R (3,3), t (3,) ground truth
    (x_cam = R X + t) for accuracy gating.
    """
    rng = np.random.default_rng(seed)
    tex = np.asarray(texture, np.float32)
    if tex.max() > 1.5:
        tex = tex / 255.0
    w, h = image_size
    K = np.array([[focal, 0, w / 2.0],
                  [0, focal, h / 2.0],
                  [0, 0, 1.0]])

    # scene: fronto-ish planes tiling the view volume at distinct depths
    planes = []
    for i in range(n_planes):
        z = 6.0 + 2.5 * i
        # plane extent grows with depth so every view sees texture
        half = 0.55 * z
        cx = rng.uniform(-0.25, 0.25) * z
        cy = rng.uniform(-0.25, 0.25) * z
        P0 = np.array([cx - half, cy - half, z])
        # small random tilt makes the planes non-fronto-parallel
        tilt = rng.uniform(-0.25, 0.25, 2)
        U = np.array([2 * half, 0.0, 2 * half * tilt[0]])
        V = np.array([0.0, 2 * half, 2 * half * tilt[1]])
        # random texture crop (at least a third of the image each way)
        u0 = rng.uniform(0, 0.5)
        v0 = rng.uniform(0, 0.5)
        u1 = u0 + rng.uniform(0.35, 0.5)
        v1 = v0 + rng.uniform(0.35, 0.5)
        planes.append((P0, U, V, (u0, v0, min(u1, 1.0), min(v1, 1.0))))
    # nearest planes LAST so they overwrite in compositing ties
    planes.sort(key=lambda p: -p[0][2])

    target = np.array([0.0, 0.0, 9.0])
    images, cameras = [], []
    for i in range(n_views):
        s = i / max(n_views - 1, 1) - 0.5
        eye = np.array([baseline * s,
                        0.35 * np.sin(2.0 * np.pi * s),
                        0.6 * abs(s)])
        R = _look_at(eye, target)
        t = -R @ eye
        img = _render_view(K, R, t, planes, tex, h, w)
        images.append(img)
        cameras.append({"K": K.copy(), "R": R, "t": t, "position": eye})
    return images, cameras
