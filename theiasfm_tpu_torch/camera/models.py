"""Camera intrinsics models as plain, batched, autodiff-ready functions
on tensors (port of theiasfm_tpu/camera/models.py).

A static model-type argument selects the distortion function. All
functions broadcast over leading batch dims and contain no
data-dependent Python control flow, so they run under
torch.func.vmap / jacrev.

Parameter layout (one padded (MAX_INTRINSICS,) vector; the leading 5
are shared by all models):
  0 FOCAL_LENGTH   (pixels; fy = focal * aspect)
  1 ASPECT_RATIO
  2 SKEW
  3 PRINCIPAL_POINT_X
  4 PRINCIPAL_POINT_Y
  5.. model-specific distortion:
  PINHOLE:                   5 k1, 6 k2                    (radial)
  PINHOLE_RADIAL_TANGENTIAL: 5 k1, 6 k2, 7 k3, 8 t1, 9 t2
  FISHEYE:                   5 k1, 6 k2, 7 k3, 8 k4        (equidistant)
  FOV:                       5 omega
  DIVISION_UNDISTORTION:     5 k

Extrinsics: a (6,) vector [position(3), orientation angle-axis(3)],
orientation = world->camera.
"""
from __future__ import annotations

import enum

import torch

from ..math import rotation as rot
from ..utils import linalg


class CameraModelType(enum.IntEnum):
    INVALID = -1
    PINHOLE = 0
    PINHOLE_RADIAL_TANGENTIAL = 1
    FISHEYE = 2
    FOV = 3
    DIVISION_UNDISTORTION = 4


NUM_PARAMS = {
    CameraModelType.PINHOLE: 7,
    CameraModelType.PINHOLE_RADIAL_TANGENTIAL: 10,
    CameraModelType.FISHEYE: 9,
    CameraModelType.FOV: 6,
    CameraModelType.DIVISION_UNDISTORTION: 6,
}

MAX_INTRINSICS = 10

FOCAL, ASPECT, SKEW, PP_X, PP_Y = 0, 1, 2, 3, 4


def _where(cond, a, b):
    """torch.where with Python-float branches promoted to b's dtype."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Distortion: normalized undistorted (x, y) -> normalized distorted (x, y)
# ---------------------------------------------------------------------------

def _distort_pinhole(intr, xy):
    r2 = torch.sum(xy * xy, dim=-1, keepdim=True)
    k1, k2 = intr[..., 5:6], intr[..., 6:7]
    d = 1.0 + r2 * (k1 + r2 * k2)
    return xy * d


def _distort_radtan(intr, xy):
    x, y = xy[..., :1], xy[..., 1:2]
    r2 = x * x + y * y
    k1, k2, k3 = intr[..., 5:6], intr[..., 6:7], intr[..., 7:8]
    t1, t2 = intr[..., 8:9], intr[..., 9:10]
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * t1 * x * y + t2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * t2 * x * y + t1 * (r2 + 2.0 * y * y)
    return torch.cat([xd, yd], dim=-1)


def _distort_fisheye(intr, xy):
    """Equidistant fisheye on the normalized plane: r = tan(theta)."""
    k1, k2, k3, k4 = (intr[..., 5:6], intr[..., 6:7], intr[..., 7:8],
                      intr[..., 8:9])
    r = torch.linalg.norm(xy, dim=-1, keepdim=True)
    r_safe = _where(r < 1e-12, 1.0, r)
    theta = torch.atan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    scale = _where(r < 1e-12, 1.0, theta_d / r_safe)
    return xy * scale


def _distort_fov(intr, xy):
    """FOV model (Devernay & Faugeras)."""
    omega = intr[..., 5:6]
    r = torch.linalg.norm(xy, dim=-1, keepdim=True)
    small_w = torch.abs(omega) < 1e-6
    safe_w = _where(small_w, 1.0, omega)
    tan_half = torch.tan(safe_w * 0.5)
    r_safe = _where(r < 1e-12, 1.0, r)
    rd = torch.atan(2.0 * r * tan_half) / safe_w
    scale = _where(small_w | (r < 1e-12), 1.0, rd / r_safe)
    return xy * scale


def _distort_division(intr, xy):
    """Division-undistortion model: forward distortion solves
    r_u = r_d / (1 + k r_d^2) for r_d."""
    k = intr[..., 5:6]
    ru = torch.linalg.norm(xy, dim=-1, keepdim=True)
    a = k * ru
    disc = torch.sqrt(torch.clamp(1.0 - 4.0 * a * ru, min=0.0))
    denom = 2.0 * a
    flat = torch.abs(denom) < 1e-12
    rd = torch.where(flat, ru, (1.0 - disc) / _where(flat, 1.0, denom))
    scale = _where(ru < 1e-12, 1.0, rd / _where(ru < 1e-12, 1.0, ru))
    return xy * scale


_DISTORT = {
    CameraModelType.PINHOLE: _distort_pinhole,
    CameraModelType.PINHOLE_RADIAL_TANGENTIAL: _distort_radtan,
    CameraModelType.FISHEYE: _distort_fisheye,
    CameraModelType.FOV: _distort_fov,
    CameraModelType.DIVISION_UNDISTORTION: _distort_division,
}


def distort(model_type: CameraModelType, intr, xy):
    """Normalized undistorted -> distorted coordinates. Static model_type."""
    return _DISTORT[CameraModelType(model_type)](intr, xy)


def _undistort_fov(intr, xy):
    omega = intr[..., 5:6]
    rd = torch.linalg.norm(xy, dim=-1, keepdim=True)
    small_w = torch.abs(omega) < 1e-6
    safe_w = _where(small_w, 1.0, omega)
    tan_half = torch.tan(safe_w * 0.5)
    rd_safe = _where(rd < 1e-12, 1.0, rd)
    ru = torch.tan(rd * safe_w) / (2.0 * tan_half)
    scale = _where(small_w | (rd < 1e-12), 1.0, ru / rd_safe)
    return xy * scale


def _undistort_division(intr, xy):
    k = intr[..., 5:6]
    r2 = torch.sum(xy * xy, dim=-1, keepdim=True)
    return xy / (1.0 + k * r2)


def undistort(model_type: CameraModelType, intr, xy, iters: int = 25):
    """Normalized distorted -> undistorted. Closed form for FOV/division;
    fixed-iteration Newton with the true 2x2 Jacobian (torch.func.jacfwd)
    otherwise."""
    mt = CameraModelType(model_type)
    if mt == CameraModelType.FOV:
        return _undistort_fov(intr, xy)
    if mt == CameraModelType.DIVISION_UNDISTORTION:
        return _undistort_division(intr, xy)

    fwd = _DISTORT[mt]
    jac = torch.func.vmap(torch.func.jacfwd(lambda u, i: fwd(i, u)))
    flat_intr = intr.expand(xy.shape[:-1] + intr.shape[-1:]).reshape(
        -1, intr.shape[-1])
    u = xy
    for _ in range(iters):
        # Newton on F(u) = fwd(u) - xy
        J = jac(u.reshape(-1, 2), flat_intr)                 # (B, 2, 2)
        F = (fwd(intr, u) - xy).reshape(-1, 2)
        delta = linalg.solve(J, F[..., None])[..., 0]
        u = u - delta.reshape(u.shape)
    return u


# ---------------------------------------------------------------------------
# Pixel mapping
# ---------------------------------------------------------------------------

def _apply_calibration(intr, xy):
    fx = intr[..., FOCAL]
    fy = fx * intr[..., ASPECT]
    skew = intr[..., SKEW]
    px = fx * xy[..., 0] + skew * xy[..., 1] + intr[..., PP_X]
    py = fy * xy[..., 1] + intr[..., PP_Y]
    return torch.stack([px, py], dim=-1)


def _remove_calibration(intr, pixel):
    fx = intr[..., FOCAL]
    fy = fx * intr[..., ASPECT]
    skew = intr[..., SKEW]
    y = (pixel[..., 1] - intr[..., PP_Y]) / fy
    x = (pixel[..., 0] - intr[..., PP_X] - skew * y) / fx
    return torch.stack([x, y], dim=-1)


def pixel_from_camera_point(model_type, intr, p_cam):
    """Camera-frame 3D point -> (pixel (..., 2), depth (...,))."""
    depth = p_cam[..., 2]
    tiny = torch.full_like(depth, 1e-12)
    tiny = torch.where(depth < 0, -tiny, tiny)
    safe_z = torch.where(torch.abs(depth) < 1e-12, tiny, depth)
    xy = p_cam[..., :2] / safe_z[..., None]
    xy_d = distort(model_type, intr, xy)
    return _apply_calibration(intr, xy_d), depth


def world_to_camera(extrinsics, point):
    """World point -> camera frame: R(aa) @ (X - position)."""
    return rot.angle_axis_rotate_point(
        extrinsics[..., 3:6], point - extrinsics[..., 0:3])


def project(model_type, extrinsics, intr, point):
    """World 3D point -> (pixel, depth): the reprojection primitive whose
    jacobians drive bundle adjustment."""
    return pixel_from_camera_point(model_type, intr,
                                   world_to_camera(extrinsics, point))


def pixel_to_normalized_ray(model_type, intr, pixel):
    """Pixel -> undistorted normalized image coords (z=1 direction)."""
    xy_d = _remove_calibration(intr, pixel)
    return undistort(model_type, intr, xy_d)


def pixel_to_world_ray(model_type, extrinsics, intr, pixel):
    """Pixel -> (origin (...,3), unit direction (...,3)) in world frame."""
    xy = pixel_to_normalized_ray(model_type, intr, pixel)
    d_cam = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    R = rot.angle_axis_to_rotation_matrix(extrinsics[..., 3:6])
    d_world = torch.einsum("...ji,...j->...i", R, d_cam)
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    origin = extrinsics[..., 0:3].expand(d_world.shape)
    return origin, d_world
