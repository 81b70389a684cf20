"""Seeded synthetic problems for the pose solvers and robust estimators,
made with numpy alone, and the minimal-solver sweep built on them.

The same generators make the inputs of chip_smoke.py's solver phases,
of tests/solvers_reference.py (which reads the JAX package on them) and
of the port's solver tests, so a gate set on the CPU and the card's
reading concern the same numbers. Each generator takes a
numpy Generator and returns a dict of float64 arrays with a leading
problem axis; cameras follow the package's convention x_cam = R (X - c)
with extrinsics [position c, angle-axis].

`MINIMAL_SOLVERS` holds, for each pose-solver module, how to make B
exact problems, how to run the port's solver on them (torch tensors on
any device and dtype) and which problems it solved: those with a valid
solution within a relative 1e-3 of the ground truth.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.device import resolve_device


def rotation(aa):
    """Rodrigues: (..., 3) angle-axis -> (..., 3, 3)."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa, axis=-1)[..., None, None]
    k = aa / np.maximum(th[..., 0], 1e-300)
    z = np.zeros(aa.shape[:-1])
    K = np.stack([z, -k[..., 2], k[..., 1], k[..., 2], z, -k[..., 0],
                  -k[..., 1], k[..., 0], z], -1).reshape(aa.shape + (3,))
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def random_angle_axis(rng, B, lo=0.1, hi=1.0):
    """B random rotations with angles uniform in [lo, hi] radians."""
    ax = rng.normal(size=(B, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    return ax * rng.uniform(lo, hi, size=(B, 1))


def distort_division(u, k):
    """Forward division-model distortion: d with u = d / (1 + k |d|^2),
    u (..., n, 2), k broadcast against (..., n)."""
    r_u = np.linalg.norm(u, axis=-1)
    k = np.broadcast_to(k, r_u.shape)
    disc = np.sqrt(np.maximum(1.0 - 4.0 * k * r_u ** 2, 0.0))
    safe = np.where(np.abs(k * r_u) > 1e-300, 2.0 * k * r_u, 1.0)
    r_d = np.where(np.abs(k * r_u) > 1e-300, (1.0 - disc) / safe, r_u)
    return u * (r_d / np.maximum(r_u, 1e-12))[..., None]


def _outliers(rng, x, share, lo, hi):
    """Replace the first share of each problem's rows by uniform
    noise."""
    n_out = int(round(share * x.shape[-2]))
    x = x.copy()
    x[..., :n_out, :] = rng.uniform(lo, hi, size=x[..., :n_out, :].shape)
    return x


def absolute_pose(rng, B, n, focal=None, noise_px=0.0, outliers=0.0,
                  distortion=None):
    """B cameras, each seeing n points 3-7 units ahead. image: normalized
    coordinates, or pixels centered on the principal point with focal
    lengths uniform in `focal` = (lo, hi); with `distortion` = (lo, hi)
    a division-model k (as k * r_max^2 in that range) distorts the
    pixels. Returns dict(world, image, extrinsics, focal, k)."""
    aa = random_angle_axis(rng, B, 0.0, 0.6)
    c = rng.normal(size=(B, 3))
    pc = rng.uniform([-1.5, -1.5, 3.0], [1.5, 1.5, 7.0], size=(B, n, 3))
    R = rotation(aa)
    world = pc @ R + c[:, None]                 # X = R^T pc + c
    img = pc[..., :2] / pc[..., 2:]
    f = np.ones(B)
    if focal is not None:
        f = rng.uniform(*focal, size=B)
        img = img * f[:, None, None]
    k = np.zeros(B)
    if distortion is not None:
        r2max = np.max(np.sum(img ** 2, -1), -1)
        k = rng.uniform(*distortion, size=B) / r2max
        img = distort_division(img, k[:, None])
    img = img + rng.normal(scale=noise_px, size=img.shape)
    if outliers:
        lim = np.abs(img).max()
        img = _outliers(rng, img, outliers, -lim, lim)
    return dict(world=world, image=img, extrinsics=np.concatenate(
        [c, aa], -1), focal=f, k=k)


def relative_pose(rng, B, n, noise=0.0):
    """B relative poses (p2 = R p1 + t, |t| = 1), each with n points at
    depth 4-10 in camera 1: normalized x1, x2 (B, n, 2), R, t."""
    R = rotation(random_angle_axis(rng, B, 0.1, 0.5))
    t = rng.normal(size=(B, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], size=(B, n, 3))
    X2 = X @ np.swapaxes(R, -1, -2) + t[:, None]
    x1 = X[..., :2] / X[..., 2:] + rng.normal(scale=noise, size=(B, n, 2))
    x2 = X2[..., :2] / X2[..., 2:] + rng.normal(scale=noise,
                                                size=(B, n, 2))
    return dict(x1=x1, x2=x2, R=R, t=t)


def _skew(v):
    z = np.zeros(v.shape[:-1])
    return np.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                     -v[..., 1], v[..., 0], z], -1).reshape(v.shape + (3,))


def essential(R, t):
    return _skew(t) @ R


def generalized_pose(rng, B, n):
    """B generalized cameras (ray origins in the camera frame) seeing n
    points: origins, dirs (unit), world (B, n, 3) with R p + t = o +
    depth d; R, t."""
    R = rotation(random_angle_axis(rng, B, 0.1, np.pi * 0.9))
    t = rng.normal(size=(B, 3)) + np.array([0.0, 0.0, 8.0])
    world = rng.uniform(-2, 2, size=(B, n, 3))
    o = rng.uniform(-0.5, 0.5, size=(B, n, 3))
    d = world @ np.swapaxes(R, -1, -2) + t[:, None] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(origins=o, dirs=d, world=world, R=R, t=t)


def generalized_similarity(rng, B, n, noise=0.0, outliers=0.0):
    """B similarities (R, t, s) aligning n points onto multi-camera rays
    (R X + t - s o parallel to d): origin, dir (unit), point (B, n, 3);
    with `noise` (radians, about) on the directions and a share of
    random `outliers` directions."""
    R = rotation(random_angle_axis(rng, B, 0.1, np.pi * 0.9))
    t = rng.normal(size=(B, 3))
    s = rng.uniform(0.3, 3.0, size=B)
    pts = rng.uniform(-2, 2, size=(B, n, 3)) + np.array([0.0, 0.0, 6.0])
    o = rng.uniform(-0.5, 0.5, size=(B, n, 3))
    d = pts @ np.swapaxes(R, -1, -2) + t[:, None] - s[:, None, None] * o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d + rng.normal(scale=noise, size=d.shape)
    if outliers:
        d = _outliers(rng, d, outliers, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(origin=o, dir=d, point=pts, R=R, t=t, s=s)


def undistorted_homogeneous(x, l):
    r2 = np.sum(x ** 2, -1)
    return np.concatenate([x, (1.0 + np.asarray(l)[..., None] * r2)[
        ..., None]], -1)


def distort_division_homogeneous(y, l):
    """(d, 1 + l |d|^2) ~ y, the physical root (numpy twin of
    sfm/pose/radial_homography.distort_division_homogeneous)."""
    rho2 = y[..., 0] ** 2 + y[..., 1] ** 2
    yz = y[..., 2]
    disc = np.sqrt(np.maximum(yz ** 2 - 4.0 * l * rho2, 0.0))
    sgn = np.where(yz < 0, -1.0, 1.0)
    tt = 0.5 * (yz + sgn * disc)
    return y[..., :2] / tt[..., None]


def radial_pairs(rng, B, n, noise=0.0, outliers=0.0):
    """B plane-induced homographies between two division-model cameras
    (l1, l2 in [-1.2, -0.1]), n distorted normalized correspondences
    each, with `noise` (normalized units) and a share of `outliers`.
    Returns dict(x1, x2, H (unit Frobenius), l1, l2)."""
    H = np.eye(3) + 0.25 * rng.normal(size=(B, 3, 3))
    H /= np.linalg.norm(H, axis=(-2, -1), keepdims=True)
    l1 = rng.uniform(-1.2, -0.1, size=B)
    l2 = rng.uniform(-1.2, -0.1, size=B)
    x1 = rng.uniform(-0.5, 0.5, size=(B, n, 2))
    y = undistorted_homogeneous(x1, l1) @ np.swapaxes(H, -1, -2)
    x2 = distort_division_homogeneous(y, l2[:, None])
    x1 = x1 + rng.normal(scale=noise, size=x1.shape)
    x2 = x2 + rng.normal(scale=noise, size=x2.shape)
    if outliers:
        x2 = _outliers(rng, x2, outliers, -0.6, 0.6)
    return dict(x1=x1, x2=x2, H=H, l1=l1, l2=l2)


def rigid_pairs(rng, B, n, with_scale=False, noise=0.0, outliers=0.0):
    """B transforms dst = s R src + t on n points each (s = 1 without
    scale), `noise` on dst and a share of random `outliers` dst."""
    R = rotation(random_angle_axis(rng, B, 0.1, np.pi * 0.9))
    t = rng.normal(size=(B, 3)) * 3.0
    s = rng.uniform(0.5, 2.0, size=B) if with_scale else np.ones(B)
    src = rng.uniform(-5, 5, size=(B, n, 3))
    dst = (s[:, None, None] * src) @ np.swapaxes(R, -1, -2) + t[:, None]
    dst = dst + rng.normal(scale=noise, size=dst.shape)
    if outliers:
        dst = _outliers(rng, dst, outliers, -10.0, 10.0)
    return dict(src=src, dst=dst, R=R, t=t, s=s)


def _about_axis(rng, B):
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi * 0.9, np.pi * 0.9, size=(B, 1))
    return axis, rotation(axis * angle)


def partial_rotation_problems(rng, B, kind):
    """Exact problems of the four partial-rotation solvers (`kind`:
    two_point, three_point, four_point, sim): the known axis, the
    solver's inputs and the true R, t (and scale)."""
    axis, R = _about_axis(rng, B)
    Rt = np.swapaxes(R, -1, -2)
    t = rng.normal(size=(B, 3))
    if kind == "two_point":
        pts = rng.uniform(-1, 1, size=(B, 2, 3)) + [0, 0, 6.0]
        cam = pts @ Rt + t[:, None]
        rays = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
        return dict(axis=axis, model_points=pts, image_rays=rays, R=R, t=t)
    if kind == "three_point":
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        X = rng.uniform(-1, 1, size=(B, 3, 3)) + [0, 0, 5.0]
        X2 = X @ Rt + t[:, None]
        return dict(axis=axis,
                    rays1=X / np.linalg.norm(X, axis=-1, keepdims=True),
                    rays2=X2 / np.linalg.norm(X2, axis=-1, keepdims=True),
                    R=R, t=t)
    if kind == "four_point":
        X = rng.uniform(-2, 2, size=(B, 4, 3)) + [0, 0, 6.0]
        o1 = rng.uniform(-0.5, 0.5, size=(B, 4, 3))
        o2 = rng.uniform(-0.5, 0.5, size=(B, 4, 3))
        d1 = X - o1
        d2 = X @ Rt + t[:, None] - o2
        return dict(axis=axis, dirs1=d1 / np.linalg.norm(
            d1, axis=-1, keepdims=True), origins1=o1, dirs2=d2 /
            np.linalg.norm(d2, axis=-1, keepdims=True), origins2=o2,
            R=R, t=t)
    if kind == "sim":
        s = rng.uniform(0.4, 2.5, size=B)
        X = rng.uniform(-2, 2, size=(B, 5, 3)) + [0, 0, 8.0]
        o1 = rng.uniform(-1, 1, size=(B, 5, 3))
        v2 = rng.uniform(-1, 1, size=(B, 5, 3))  # view-2 centers (frame 1)
        d1 = X - o1
        # frame 2 quantities: X = s R X2 + t
        o2 = ((v2 - t[:, None]) @ R) / s[:, None, None]
        d2 = (X - v2) / np.linalg.norm(X - v2, axis=-1, keepdims=True) @ R
        return dict(axis=axis, dirs1=d1 / np.linalg.norm(
            d1, axis=-1, keepdims=True), origins1=o1, dirs2=d2,
            origins2=o2, R=R, t=t, s=s)
    raise ValueError(kind)


# ------------------------------------------------------- minimal solvers

REL_TOL = 1e-3


def _rel(a, b):
    """max |a - b| / max(1, max |b|) over the trailing axis."""
    return np.max(np.abs(a - b), -1) / np.maximum(1.0, np.max(np.abs(b),
                                                              -1))


def _any_hit(valid, err):
    return np.any(valid & (err < REL_TOL), axis=-1)


def _np(x):
    return x.detach().cpu().double().numpy()


def _make_focal_from_fundamental(rng, B):
    p = relative_pose(rng, B, 1)
    f1 = rng.uniform(400, 1600, B)
    f2 = rng.uniform(400, 1600, B)
    Kinv = lambda f: np.stack([np.diag([1 / x, 1 / x, 1.0]) for x in f])
    F = np.swapaxes(Kinv(f2), -1, -2) @ essential(p["R"], p["t"]) @ \
        Kinv(f1)
    F /= np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    return dict(F=F), dict(f=np.stack([f1, f2], -1))


def _run_focal_from_fundamental(x):
    from .sfm.pose.focal_from_fundamental import \
        focal_lengths_from_fundamental
    z = x["F"].new_zeros(x["F"].shape[:-2] + (2,))
    return focal_lengths_from_fundamental(x["F"], z, z)


def _hit_focal_from_fundamental(out, truth):
    f1, f2, valid = (_np(v) for v in out)
    est = np.stack([f1, f2], -1)
    return (valid > 0) & np.all(np.abs(est - truth["f"]) / truth["f"] <
                                REL_TOL, -1)


def _make_seven_point(rng, B):
    p = relative_pose(rng, B, 7)
    E = essential(p["R"], p["t"])
    return dict(x1=p["x1"], x2=p["x2"]), dict(
        F=E / np.linalg.norm(E, axis=(-2, -1), keepdims=True))


def _run_seven_point(x):
    from .sfm.pose.seven_point import seven_point_fundamental
    return seven_point_fundamental(x["x1"], x["x2"])


def _hit_seven_point(out, truth):
    F, valid = _np(out[0]).reshape(out[0].shape[:-2] + (9,)), _np(out[1])
    Ft = truth["F"].reshape(-1, 1, 9)
    err = np.minimum(np.abs(F - Ft).max(-1), np.abs(F + Ft).max(-1))
    return _any_hit(valid > 0, err)


def _make_known_rotation(rng, B):
    p = relative_pose(rng, B, 2)
    return dict(x1=p["x1"], x2=p["x2"], R=p["R"]), dict(t=p["t"])


def _run_known_rotation(x):
    from .sfm.pose.known_rotation import \
        relative_pose_from_two_points_with_known_rotation as solve
    return solve(x["x1"], x["x2"], x["R"])


def _hit_known_rotation(out, truth):
    t, valid = _np(out[0]), _np(out[1])
    return (valid > 0) & (_rel(t, truth["t"]) < REL_TOL)


def _make_dlt_pnp(rng, B):
    p = absolute_pose(rng, B, 6, focal=(400, 1600))
    return dict(world=p["world"], image=p["image"]), dict(
        model=np.concatenate([p["extrinsics"], p["focal"][:, None],
                              np.ones((B, 1)), np.zeros((B, 2))], -1))


def _run_dlt_pnp(x):
    from .sfm.pose.dlt_pnp import six_point_pnp
    return six_point_pnp(x["world"], x["image"])


def _pose_focal_err(m, truth):
    """Relative error of [extrinsics, focal(, k ...)] models (..., C, P)
    against the truth (..., P): the extrinsics as one vector, the focal
    length and each further entry relative to itself."""
    t = truth[:, None]
    e = _rel(m[..., :6], t[..., :6])
    for i in range(6, t.shape[-1]):
        e = np.maximum(e, np.abs(m[..., i] - t[..., i]) /
                       np.maximum(np.abs(t[..., i]), 1e-300))
    return e


def _hit_dlt_pnp(out, truth):
    m, valid = _np(out[0]), _np(out[1])
    t = truth["model"][:, None]
    err = np.maximum(_pose_focal_err(m[..., :7], truth["model"][:, :7]),
                     np.abs(m[..., 7:] - t[..., 7:]).max(-1))
    return _any_hit(valid > 0, err)


def _make_epnp(rng, B):
    p = absolute_pose(rng, B, 6)
    return dict(world=p["world"], image=p["image"]), dict(
        extrinsics=p["extrinsics"])


def _run_epnp(x):
    from .sfm.pose.epnp import epnp
    return epnp(x["world"], x["image"])


def _hit_epnp(out, truth):
    e, ok = _np(out[0]), _np(out[1])
    return (ok > 0) & (_rel(e, truth["extrinsics"]) < REL_TOL)


def _make_p4pf(rng, B):
    p = absolute_pose(rng, B, 4, focal=(400, 1600))
    return dict(world=p["world"], image=p["image"]), dict(
        model=np.concatenate([p["extrinsics"], p["focal"][:, None]], -1))


def _run_p4pf(x):
    from .sfm.pose.p4pf import p4pf
    return p4pf(x["world"], x["image"])


def _hit_pose_focal(out, truth):
    m, valid = _np(out[0]), _np(out[1])
    return _any_hit(valid > 0, _pose_focal_err(m, truth["model"]))


def _make_p4pfr(rng, B):
    p = absolute_pose(rng, B, 4, focal=(400, 1600),
                      distortion=(-0.5, -0.05))
    return dict(world=p["world"], image=p["image"]), dict(
        model=np.concatenate([p["extrinsics"], p["focal"][:, None],
                              p["k"][:, None]], -1))


def _run_p4pfr(x):
    from .sfm.pose.pnp_focal_radial import \
        four_point_focal_length_radial_distortion as solve
    return solve(x["world"], x["image"])


def _make_upnp(rng, B):
    p = generalized_pose(rng, B, 6)
    return dict(origins=p["origins"], dirs=p["dirs"], world=p["world"]), \
        dict(Rt=np.concatenate([p["R"].reshape(B, 9), p["t"]], -1))


def _run_upnp(x):
    from .sfm.pose.upnp import upnp
    return upnp(x["origins"], x["dirs"], x["world"])


def _hit_upnp(out, truth):
    R, t = _np(out[0]), _np(out[1])
    est = np.concatenate([R.reshape(len(R), 9), t], -1)
    return _rel(est, truth["Rt"]) < REL_TOL


def _make_gdls(rng, B):
    p = generalized_similarity(rng, B, 4)
    return dict(origin=p["origin"], dir=p["dir"], point=p["point"]), dict(
        Rts=np.concatenate([p["R"].reshape(B, 9), p["t"], p["s"][:, None]],
                           -1))


def _run_gdls(x):
    from .sfm.pose.gdls import gdls_similarity_transform
    return gdls_similarity_transform(x["origin"], x["dir"], x["point"])


def _hit_gdls(out, truth):
    R, t, s = _np(out[0]), _np(out[1]), _np(out[2])
    est = np.concatenate([R.reshape(len(R), 9), t, s[:, None]], -1)
    return _rel(est, truth["Rts"]) < REL_TOL


def _make_radial_homography(rng, B):
    p = radial_pairs(rng, B, 6)
    return dict(x1=p["x1"], x2=p["x2"]), dict(
        H=p["H"].reshape(B, 9), l=np.stack([p["l1"], p["l2"]], -1))


def _run_radial_homography(x):
    from .sfm.pose.radial_homography import \
        six_point_radial_distortion_homography as solve
    return solve(x["x1"], x["x2"])


def _hit_radial_homography(out, truth):
    m, valid = _np(out[0]), _np(out[1])
    H = truth["H"][:, None]
    err = np.maximum(np.minimum(np.abs(m[..., :9] - H).max(-1),
                                np.abs(m[..., :9] + H).max(-1)),
                     _rel(m[..., 9:], truth["l"][:, None]))
    return _any_hit(valid > 0, err)


def _make_partial_rotation(rng, B):
    p = partial_rotation_problems(rng, B, "three_point")
    return dict(axis=p["axis"], rays1=p["rays1"], rays2=p["rays2"]), dict(
        Rt=np.concatenate([p["R"].reshape(B, 9), p["t"]], -1))


def _run_partial_rotation(x):
    from .sfm.pose.partial_rotation import \
        three_point_relative_pose_partial_rotation as solve
    return solve(x["axis"], x["rays1"], x["rays2"])


def _hit_partial_rotation(out, truth):
    R, t, valid = _np(out[0]), _np(out[1]), _np(out[2])
    est = np.concatenate([R.reshape(R.shape[:-2] + (9,)), t], -1)
    return _any_hit(valid > 0, _rel(est, truth["Rt"][:, None]))


# module -> (make(rng, B) -> (inputs, truth), run(torch inputs) ->
# outputs, hit(outputs, truth) -> (B,) bool)
MINIMAL_SOLVERS = {
    "focal_from_fundamental": (_make_focal_from_fundamental,
                               _run_focal_from_fundamental,
                               _hit_focal_from_fundamental),
    "seven_point": (_make_seven_point, _run_seven_point, _hit_seven_point),
    "known_rotation": (_make_known_rotation, _run_known_rotation,
                       _hit_known_rotation),
    "dlt_pnp": (_make_dlt_pnp, _run_dlt_pnp, _hit_dlt_pnp),
    "epnp": (_make_epnp, _run_epnp, _hit_epnp),
    "p4pf": (_make_p4pf, _run_p4pf, _hit_pose_focal),
    "pnp_focal_radial": (_make_p4pfr, _run_p4pfr, _hit_pose_focal),
    "upnp": (_make_upnp, _run_upnp, _hit_upnp),
    "gdls": (_make_gdls, _run_gdls, _hit_gdls),
    "radial_homography": (_make_radial_homography, _run_radial_homography,
                          _hit_radial_homography),
    "partial_rotation": (_make_partial_rotation, _run_partial_rotation,
                         _hit_partial_rotation),
}


def minimal_problems(name, seed, B):
    """The `name` sweep's B problems from numpy seed `seed`."""
    return MINIMAL_SOLVERS[name][0](np.random.default_rng(seed), B)


def run_minimal(name, inputs, dtype=torch.float32, device="cuda",
                chunk=None):
    """The port's `name` solver on numpy inputs, in `dtype` on `device`,
    `chunk` problems per call (all at once by default). Returns the
    outputs as a tuple of tensors on `device`."""
    run = MINIMAL_SOLVERS[name][1]
    device = resolve_device(device)
    B = len(next(iter(inputs.values())))
    chunk = chunk or B
    parts = []
    for s in range(0, B, chunk):
        x = {k: torch.as_tensor(v[s:s + chunk], dtype=dtype, device=device)
             for k, v in inputs.items()}
        parts.append(run(x))
    return tuple(torch.cat(p) for p in zip(*parts))


def minimal_hits(name, outputs, truth):
    return MINIMAL_SOLVERS[name][2](outputs, truth)


# ------------------------------------------------ L1 and box-QP problems

# the dense shape of the relative-translation system of a 1DSfM-scale
# view graph: 5,530 relative translations (3 rows each) over 553 views'
# positions (3 unknowns each); 553 inequality rows
L1_SHAPE = (16_590, 1_659)
L1_INEQUALITIES = 553
QP_N = 1_659


def l1_problem(seed, m=L1_SHAPE[0], n=L1_SHAPE[1], outliers=0.1,
               n_ineq=L1_INEQUALITIES):
    """An L1 regression as tests/test_math_solvers.py builds one, at
    (m, n): A and x_true normal (x_true >= 0.5 in magnitude, positive),
    b = A x_true + N(0, 0.01), a share `outliers` of the rows plus
    N(0, 20); and n_ineq constraints -x_i <= -0.2 on the first n_ineq
    unknowns (not binding at x_true). float64 arrays."""
    rng = np.random.default_rng(seed)
    x_true = np.abs(rng.normal(size=n)) + 0.5
    A = rng.normal(size=(m, n))
    b = A @ x_true + rng.normal(scale=0.01, size=m)
    k = int(round(outliers * m))
    idx = rng.choice(m, k, replace=False)
    b[idx] += rng.normal(scale=20.0, size=k)
    C = -np.eye(n)[:n_ineq]
    d = np.full(n_ineq, -0.2)
    return dict(A=A, b=b, C=C, d=d, x_true=x_true)


def qp_problem(seed, n=QP_N):
    """A box QP as tests/test_math_solvers.py's test_qp_box builds one,
    at n: P = M M^T / n + I (eigenvalues in [1, ~5]), q = -P x_uncon
    with x_uncon normal, box [-0.5, 0.5]. float64 arrays."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + np.eye(n)
    x_uncon = rng.normal(size=n)
    return dict(P=P, q=-P @ x_uncon, lo=np.full(n, -0.5),
                hi=np.full(n, 0.5))


def l1_recovery(x, x_true):
    """RMS error of an L1 solution against the truth."""
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(x - x_true) / np.sqrt(len(x_true)))


def qp_kkt(x, P, q, lo, hi):
    """The projected-gradient residual max |x - clip(x - (P x + q), lo,
    hi)| of a box-QP solution: 0 exactly at the optimum (the KKT
    conditions test_qp_box checks one by one)."""
    x = np.asarray(x, np.float64)
    g = P @ x + q
    return float(np.abs(x - np.clip(x - g, lo, hi)).max())
