"""The camera model and the robust loss of the BAL cells, in plain torch.

Independent of the program under test: the benchmark's generator and its
reference solver share these functions, and neither imports anything of
the port.

The model is the port's PINHOLE camera, the layout its problems carry:
extrinsics (6,) = [position, world-to-camera angle-axis], intrinsics
(10,) = [focal, aspect, skew, principal x, principal y, k1, k2, ...]
with the radial factor 1 + r2 (k1 + r2 k2) on the normalised plane.
BAL's own camera is the same map up to the sign of its image axes; its
optimised intrinsics are the focal length, k1 and k2 (slots 0, 5, 6).
"""
from __future__ import annotations

import torch

# below this angle a rotation is applied to first order, as Ceres does
SMALL_ANGLE = 1e-6
# an observation whose depth is at most this lies behind its camera
MIN_DEPTH = 1e-8


def rotate(aa, p):
    """Rotate points p (..., 3) by angle-axis aa (..., 3) (Rodrigues)."""
    theta = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True))
    small = theta < SMALL_ANGLE
    k = aa / torch.where(small, torch.ones_like(theta), theta)
    c, s = torch.cos(theta), torch.sin(theta)
    kxp = torch.linalg.cross(k, p, dim=-1)
    kdp = torch.sum(k * p, dim=-1, keepdim=True)
    full = p * c + kxp * s + k * kdp * (1.0 - c)
    return torch.where(small, p + torch.linalg.cross(aa, p, dim=-1), full)


def project(extr, intr, pts):
    """Pixels (..., 2) and depths (...,) of world points pts (..., 3) seen
    by cameras extr (..., 6) with intrinsics intr (..., 10)."""
    pc = rotate(extr[..., 3:6], pts - extr[..., 0:3])
    z = pc[..., 2]
    safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    x, y = pc[..., 0] / safe, pc[..., 1] / safe
    r2 = x * x + y * y
    d = 1.0 + r2 * (intr[..., 5] + r2 * intr[..., 6])
    x, y = x * d, y * d
    f = intr[..., 0]
    u = f * x + intr[..., 2] * y + intr[..., 3]
    v = f * intr[..., 1] * y + intr[..., 4]
    return torch.stack([u, v], dim=-1), z


def residuals(extr, intr, pts, pix):
    """Reprojection residuals (..., 2), zero for an observation behind its
    camera, and the mask of those observations."""
    uv, z = project(extr, intr, pts)
    behind = z <= MIN_DEPTH
    r = torch.where(behind[..., None], torch.zeros_like(uv), uv - pix)
    return r, behind


def huber_rho(s, a):
    """Huber's loss of the squared norm s at scale a: s inside a², else
    2 a sqrt(s) - a²."""
    return torch.where(s <= a * a, s,
                       2.0 * a * torch.sqrt(s.clamp(min=1e-30)) - a * a)


def huber_weight(s, a):
    """sqrt(rho'(s)): the IRLS weight of a residual of squared norm s."""
    return torch.where(s <= a * a, torch.ones_like(s),
                       torch.sqrt(a / torch.sqrt(s.clamp(min=1e-30))))
