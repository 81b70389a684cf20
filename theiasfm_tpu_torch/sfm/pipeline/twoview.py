"""Two-view geometry estimation from correspondences (port of
theiasfm_tpu/sfm/pipeline/twoview.py).

ref: src/theia/sfm/estimate_twoview_info.{h,cc} — calibrated pairs use
5-pt essential RANSAC with a resolution-scaled threshold. Returns a
TwoViewInfo (relative rotation/position) and the inlier mask.

Where the JAX module takes a PRNG key these take `samples`: a
torch.Generator or precomputed sample indices (see solvers/ransac.py),
on `device`, where they run: the card unless the caller passes "cpu".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...math import rotation as rot
from ...solvers import RansacOptions, ransac_batch
from ...utils.device import full_f32, resolve_device
from ..estimators import estimate_relative_pose
from ..estimators.twoview_estimators import _singleton_spec
from ..pose.twoview_utils import relative_pose_from_essential
from ..view_graph import TwoViewInfo


@dataclasses.dataclass(frozen=True)
class TwoViewInfoOptions:
    """ref: estimate_twoview_info.h:51-73."""
    max_sampson_error_pixels: float = 2.25
    num_hypotheses: int = 256
    min_inliers: int = 30


def samples_on(samples, device):
    """The resolved `device`; raises unless `samples` (a
    torch.Generator, an index tensor or a tuple of them) lie on it."""
    dev = resolve_device(device)
    parts = (samples if isinstance(samples, (tuple, list)) else
             (samples,))
    for s in parts:
        d = s.device
        if d.type != dev.type or (d.index is not None and dev.index
                                  is not None and d.index != dev.index):
            raise ValueError(f"samples on {d}, computation on {dev}: "
                             "draw them on the device the call runs on")
    return dev


def scaled_residuals(spec, thresh):
    """`spec` with its residuals divided by a per-problem threshold
    thresh (B,), so one engine threshold of 1 serves every pair."""
    return dataclasses.replace(
        spec, residuals=lambda M, d: spec.residuals(M, d) /
        thresh[:, None, None])


@full_f32()
def estimate_twoview_info_batch(samples, pix1, pix2, mask, focal1, focal2,
                                pp1, pp2, opts: TwoViewInfoOptions,
                                dtype=torch.float32, device="cuda"):
    """Two-view estimation over P pairs in one batched computation.

    pix1/pix2 (P, N, 2) padded pixel correspondences; mask (P, N);
    focal (P,), pp (P, 2); samples a torch.Generator or (P, H, 5)
    indices on `device`. Returns (list of TwoViewInfo or None, inliers
    (P, N) np.ndarray)."""
    dev = samples_on(samples, device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)
    f1, f2 = t(focal1), t(focal2)
    x1 = (t(pix1) - t(pp1)[:, None, :]) / f1[:, None, None]
    x2 = (t(pix2) - t(pp2)[:, None, :]) / f2[:, None, None]
    thresh = opts.max_sampson_error_pixels ** 2 / (f1 * f2)
    mask = torch.as_tensor(np.asarray(mask), device=dev)
    ropts = RansacOptions(error_thresh=1.0,  # residuals pre-scaled
                          num_hypotheses=opts.num_hypotheses)
    spec = scaled_residuals(_singleton_spec("relative_pose"), thresh)
    E, summary = ransac_batch(samples, spec, {"x1": x1, "x2": x2}, ropts,
                              data_mask=mask)
    R, tr, _ = relative_pose_from_essential(E, x1, x2,
                                            mask=summary.inliers)
    aa = rot.rotation_matrix_to_angle_axis(R)
    R, tr, aa, n_inl, inliers = (x.cpu().numpy() for x in (
        R, tr, aa, summary.num_inliers, summary.inliers))
    infos = []
    for p in range(len(n_inl)):
        if n_inl[p] < opts.min_inliers:
            infos.append(None)
            continue
        infos.append(TwoViewInfo(
            focal_length_1=float(np.asarray(focal1)[p]),
            focal_length_2=float(np.asarray(focal2)[p]),
            rotation_2=aa[p], position_2=-(R[p].T @ tr[p]),
            num_verified_matches=int(n_inl[p])))
    return infos, inliers


@full_f32()
def estimate_twoview_info(samples, pix1, pix2, focal1, focal2, opts,
                          pp1=(0.0, 0.0), pp2=(0.0, 0.0),
                          dtype=torch.float32, device="cuda"):
    """Calibrated two-view estimation of one pair.

    pix1/pix2: (N, 2) pixel coords; focals and principal points from
    the priors (ref CalibratedEstimateTwoViewInfo,
    estimate_twoview_info.cc:131+); samples a torch.Generator or (H, 5)
    indices into the correspondences padded to a bucket of 64, on
    `device`. Returns (TwoViewInfo, inlier_mask (N,) np.ndarray)."""
    dev = samples_on(samples, device)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)
    x1 = (t(pix1) - t(pp1)) / focal1
    x2 = (t(pix2) - t(pp2)) / focal2
    # resolution-scaled threshold in normalized units
    thresh = opts.max_sampson_error_pixels / np.sqrt(focal1 * focal2)
    ropts = RansacOptions(error_thresh=float(thresh) ** 2,
                          num_hypotheses=opts.num_hypotheses)
    out = estimate_relative_pose(samples, x1, x2, ropts)
    R = out["R"].cpu().numpy()
    info = TwoViewInfo(
        focal_length_1=float(focal1),
        focal_length_2=float(focal2),
        rotation_2=rot.rotation_matrix_to_angle_axis(out["R"]).cpu().numpy(),
        # position of camera 2 in the camera-1 frame: c2 = -R^T t
        position_2=-R.T @ out["t"].cpu().numpy(),
        num_verified_matches=int(out["num_inliers"]),
    )
    return info, out["inliers"].cpu().numpy()
