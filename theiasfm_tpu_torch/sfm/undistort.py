"""Undistortion of images, features, and reconstructions (port of
theiasfm_tpu/sfm/undistort.py).

ref: src/theia/sfm/undistort_image.{h,cc} (resample an image through
the camera's distortion model into an undistorted pinhole camera) and
UndistortReconstruction (replace cameras with distortion-free models,
mapping feature observations).

The JAX module builds the source map with jnp and resamples it in
numpy; here both run on `device` (the card by default; it raises
without one), with the same arithmetic: the pixel grid in float32, the
map in `dtype`, the source clipped to [0, W - 1.001] x [0, H - 1.001],
truncated to int, and bilinear weights from the fractional parts. The
resampling is one gather of the four neighbours over the full grid.
"""
from __future__ import annotations

import numpy as np
import torch

from ..camera import models as cm
from ..utils.device import resolve_device
from .reconstruction import Reconstruction


def _intrinsics(camera, dtype, device):
    return torch.as_tensor(np.asarray(camera.intrinsics), dtype=dtype,
                           device=device)


def undistort_points(camera, points_px, dtype=torch.float32,
                     device="cuda") -> np.ndarray:
    """Distorted pixel coords (N, 2) -> undistorted pixel coords (same K),
    computed in `dtype` on `device`."""
    device = resolve_device(device)
    intr = _intrinsics(camera, dtype, device)
    pts = torch.as_tensor(np.asarray(points_px), dtype=dtype, device=device)
    with torch.no_grad():
        xy_d = cm._remove_calibration(intr, pts)
        xy_u = cm.undistort(int(camera.model_type), intr, xy_d)
        out = cm._apply_calibration(intr, xy_u)
    return out.cpu().numpy()


def undistort_image(camera, image: np.ndarray, dtype=torch.float32,
                    device="cuda") -> np.ndarray:
    """Resample `image` (H, W[, C]) so the output is distortion-free
    under the same linear calibration. For each undistorted output
    pixel, sample the source at its distorted location (bilinear). The
    output is float32 for dtype float32 and float64 for float64, as the
    JAX module's is without and with x64."""
    device = resolve_device(device)
    H, W = image.shape[:2]
    intr = _intrinsics(camera, dtype, device)
    with torch.no_grad():
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=device),
            torch.arange(W, dtype=torch.float32, device=device),
            indexing="ij")
        pix = torch.stack([xs, ys], -1).reshape(-1, 2).to(dtype)
        xy_u = cm._remove_calibration(intr, pix)
        xy_d = cm.distort(int(camera.model_type), intr, xy_u)
        src = cm._apply_calibration(intr, xy_d)
        del pix, xy_u, xy_d
        sx = src[:, 0].clamp(0, W - 1.001)
        sy = src[:, 1].clamp(0, H - 1.001)
        x0 = sx.to(torch.int64)          # truncation, as astype(int32)
        y0 = sy.to(torch.int64)
        fx = sx - x0
        fy = sy - y0
        if image.ndim == 3:
            fx, fy = fx[:, None], fy[:, None]
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=device).reshape(H * W, -1)
        img = img.to(torch.promote_types(torch.float32, dtype))

        def at(y, x):
            v = img[y * W + x]
            return v if image.ndim == 3 else v[:, 0]
        out = (at(y0, x0) * (1 - fy) * (1 - fx) +
               at(y0, x0 + 1) * (1 - fy) * fx +
               at(y0 + 1, x0) * fy * (1 - fx) +
               at(y0 + 1, x0 + 1) * fy * fx)
    return out.reshape(image.shape).cpu().numpy()


def undistort_reconstruction(recon: Reconstruction, dtype=torch.float32,
                             device="cuda"):
    """In-place: move all feature observations to undistorted coords and
    zero the distortion parameters (ref UndistortReconstruction); the
    points are undistorted in `dtype` on `device`."""
    device = resolve_device(device)
    for vid, view in recon.views.items():
        cam = view.camera
        if not np.any(cam.intrinsics[5:]):
            continue
        if view.features:
            tids = list(view.features.keys())
            pts = np.stack([view.features[t] for t in tids])
            und = undistort_points(cam, pts, dtype, device)
            for t, p in zip(tids, und):
                view.features[t] = p.astype(np.float64)
        cam.intrinsics[5:] = 0.0
        cam.model_type = cm.CameraModelType.PINHOLE


def colorize_reconstruction(recon: Reconstruction, image_loader):
    """Average per-track colors from observing images (host numpy).
    ref: src/theia/sfm/colorize_reconstruction.{h,cc}.
    image_loader: name -> (H, W, 3) float [0,1] array."""
    sums = {t: np.zeros(3) for t in recon.tracks}
    counts = {t: 0 for t in recon.tracks}
    for vid, view in recon.views.items():
        img = image_loader(view.name)
        if img is None:
            continue
        H, W = img.shape[:2]
        for t, feat in view.features.items():
            x = int(np.clip(feat[0], 0, W - 1))
            y = int(np.clip(feat[1], 0, H - 1))
            sums[t] += img[y, x][:3]
            counts[t] += 1
    for t, tr in recon.tracks.items():
        if counts[t]:
            tr.color = np.clip(sums[t] / counts[t] * 255.0, 0,
                               255).astype(np.uint8)
