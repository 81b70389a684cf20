"""Full two-view match geometric verification (port of
theiasfm_tpu/sfm/pipeline/geometric_verification.py).

ref: src/theia/sfm/two_view_match_geometric_verification.{h,cc}:53-120:
  1. EstimateTwoViewInfo (5-pt RANSAC)           [twoview.py]
  2. optional guided epipolar matching to grow the inlier set
  3. triangulate inliers, reject points with bad triangulation
  4. two-view bundle adjustment
  5. final reprojection-error filter.

`verify_matches_batch` verifies a chunk's pairs in one batched
computation on `device` (the card unless the caller passes "cpu"), in
full float32 there (TF32 would move Sampson residuals across their
threshold and flip inlier decisions): a leading pair axis through
every stage, no per-pair loop on the device side, one read-back at the
end. Its stages run under the profiler ranges verify.ransac_e,
verify.ransac_h, verify.guided, verify.ba, verify.triangulate and
verify.store (the read-back and the host-side TwoViewInfo), which
chip_smoke.py reads for its time breakdown.

Where the JAX module takes a PRNG key these take `samples`: a
torch.Generator, or the sample indices as VerificationSamples, on
`device`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ...math import rotation as rot
from ...matching.guided_matcher import guided_epipolar_matching
from ...solvers import RansacOptions, random_samples, ransac_batch
from ...utils import next_bucket
from ...utils.device import full_f32
from .. import triangulation as tri
from ..ba.two_view import bundle_adjust_two_views_angular
from ..estimators import estimate_homography
from ..estimators.twoview_estimators import _singleton_spec
from ..pose.twoview_utils import (essential_from_rt,
                                  fundamental_from_essential,
                                  relative_pose_from_essential)
from ..view_graph import TwoViewInfo
from ..visibility_pyramid import visibility_score_of_inliers
from .twoview import (TwoViewInfoOptions, estimate_twoview_info,
                      samples_on, scaled_residuals)


@dataclasses.dataclass(frozen=True)
class GeometricVerificationOptions:
    """ref: two_view_match_geometric_verification.h Options."""
    estimate_twoview_info: TwoViewInfoOptions = TwoViewInfoOptions()
    guided_matching: bool = False
    guided_matching_max_distance_pixels: float = 4.0
    min_num_inlier_matches: int = 30
    bundle_adjustment: bool = True
    triangulation_max_reprojection_error_pixels: float = 15.0
    min_triangulation_angle_degrees: float = 2.0
    final_max_reprojection_error_pixels: float = 4.0


class VerificationSamples(NamedTuple):
    """Sample indices for verification: 5-point essential hypotheses
    (..., H, 5) and 4-point homography hypotheses (..., H, 4), both into
    the (padded) putative matches."""
    essential: torch.Tensor
    homography: torch.Tensor


def draw_verification_samples(generator, mask, num_hypotheses):
    """Uniform samples of the valid putative matches (mask (..., N)) on
    the generator's device."""
    mask = mask.to(generator.device)
    N = mask.shape[-1]
    return VerificationSamples(
        essential=random_samples(generator, N, 5, num_hypotheses, mask),
        homography=random_samples(generator, N, 4, num_hypotheses, mask))


def _tensor(x, dev):
    """A host array or a tensor as a tensor on dev."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor)
                           else np.asarray(x), device=dev)


def _size_scale(size):
    if not size or (not size[0] and not size[1]):
        return 1.0
    return max(size[0], size[1]) / 1024.0


def count_homography_inliers(samples, pix1, pix2,
                             max_sampson_error_pixels: float,
                             image_size1=None, image_size2=None,
                             num_hypotheses: int = 256,
                             dtype=torch.float32, device="cuda") -> int:
    """4-pt homography RANSAC over putative matches; returns the inlier
    count that flags rotation-only / planar-degenerate pairs.

    ref: two_view_match_geometric_verification.cc:328-363
    (CountHomographyInliers) with the resolution-scaled threshold of
    reconstruction_estimator_utils.cc:95-106 (max_dim / 1024). samples:
    a torch.Generator or (H, 4) indices into the matches padded to a
    bucket of 64, on `device`."""
    dev = samples_on(samples, device)
    thresh = (max_sampson_error_pixels * _size_scale(image_size1) *
              max_sampson_error_pixels * _size_scale(image_size2))
    ropts = RansacOptions(error_thresh=float(thresh),
                          num_hypotheses=num_hypotheses)
    out = estimate_homography(
        samples, torch.as_tensor(np.asarray(pix1), device=dev).to(dtype),
        torch.as_tensor(np.asarray(pix2), device=dev).to(dtype), ropts)
    return int(out["num_inliers"])


def _verify_chunk(idx_e, idx_h, x1, x2, pix1, pix2, mask, th, hth, f1, f2,
                  pp1, pp2, final_px, band_px, num_hypotheses,
                  bundle_adjustment, guided=None, lowes_ratio=0.9):
    """The whole verification of P pairs: 5-pt RANSAC, homography count,
    optional guided matching, two-view BA and the triangulation gates.
    guided: (kp1, kp2, desc1, desc2, fmask1, fmask2) of the pairs'
    padded features, or None."""
    dtype = x1.dtype
    P = x1.shape[0]
    ropts = RansacOptions(error_thresh=1.0, num_hypotheses=num_hypotheses)
    with record_function("verify.ransac_e"):
        spec = scaled_residuals(_singleton_spec("relative_pose"), th)
        E, summary = ransac_batch(idx_e, spec, {"x1": x1, "x2": x2}, ropts,
                                  data_mask=mask)
        R, t, _ = relative_pose_from_essential(E, x1, x2,
                                               mask=summary.inliers)
    with record_function("verify.ransac_h"):
        # homography inliers over the putative matches (pixel space,
        # resolution-scaled threshold, ref CountHomographyInliers)
        hspec = scaled_residuals(_singleton_spec("homography"), hth)
        _, hsum = ransac_batch(idx_h, hspec, {"x1": pix1, "x2": pix2},
                               ropts, data_mask=mask)
    w = (summary.inliers & mask).to(dtype)
    aa = rot.rotation_matrix_to_angle_axis(R)

    if guided is not None:
        with record_function("verify.guided"):
            # grow the match set along the epipolar lines of the RANSAC
            # pose over all features (the pre-BA pose, as the single-
            # pair path and ref guided_epipolar_matcher.cc)
            kp1, kp2, de1, de2, fm1, fm2 = guided
            F = fundamental_from_essential(E, f1, f2, pp1, pp2)
            nomatch = torch.zeros_like(fm1)
            gidx2, gvalid = guided_epipolar_matching(
                F, kp1, kp2, de1, de2, fm1, fm2, nomatch, nomatch,
                band_pixels=band_px, lowes_ratio=lowes_ratio)
            g1 = (kp1 - pp1[:, None]) / f1[:, None, None]
            kp2g = torch.gather(kp2, 1, gidx2.long()[..., None].expand(
                -1, -1, 2))
            g2 = (kp2g - pp2[:, None]) / f2[:, None, None]
            a_all = torch.cat([x1, g1], dim=1)
            b_all = torch.cat([x2, g2], dim=1)
            w_all = torch.cat([w, gvalid.to(dtype)], dim=1)
    else:
        gidx2 = torch.zeros((P, 0), dtype=torch.int32, device=x1.device)
        a_all, b_all, w_all = x1, x2, w

    if bundle_adjustment:
        with record_function("verify.ba"):
            # two-view BA on the (grown) inlier set, skipped below 8
            # inliers (an ill-conditioned refinement from fewer can
            # still pass the final gate)
            aa_ba, t_ba = bundle_adjust_two_views_angular(aa, t, a_all,
                                                          b_all, w_all)
            enough = (w_all.sum(dim=-1) >= 8)[:, None]
            aa2 = torch.where(enough, aa_ba, aa)
            t2 = torch.where(enough, t_ba, t)
    else:
        aa2, t2 = aa, t
    with record_function("verify.triangulate"):
        R2 = rot.angle_axis_to_rotation_matrix(aa2)
        # triangulate + cheirality + reprojection gate
        P1 = torch.eye(3, 4, dtype=dtype, device=x1.device)
        P2 = torch.cat([R2, t2[..., None]], dim=-1)
        X = tri.triangulate_dlt(P1, P2[:, None], a_all, b_all)
        w4 = X[..., 3:]
        w4 = torch.where(w4.abs() < 1e-12, torch.full_like(w4, 1e-12), w4)
        Xc1 = X[..., :3] / w4
        Xc2 = Xc1 @ R2.transpose(-1, -2) + t2[:, None]
        ok = (Xc1[..., 2] > 1e-6) & (Xc2[..., 2] > 1e-6)
        r1 = torch.linalg.norm(
            Xc1[..., :2] / torch.clamp(Xc1[..., 2:], min=1e-9) - a_all,
            dim=-1) * f1[:, None]
        r2 = torch.linalg.norm(
            Xc2[..., :2] / torch.clamp(Xc2[..., 2:], min=1e-9) - b_all,
            dim=-1) * f2[:, None]
        keep = (w_all > 0) & ok & (r1 < final_px) & (r2 < final_px)
    return aa2, t2, R2, keep, keep.sum(dim=-1), hsum.num_inliers, gidx2


@full_f32()
def verify_matches_batch(samples, pix1, pix2, mask, focal1, focal2,
                         pp1, pp2, image_sizes,
                         opts: GeometricVerificationOptions = None,
                         kp1_all=None, kp2_all=None, desc1=None,
                         desc2=None, fmask1=None, fmask2=None,
                         dtype=torch.float32, device="cuda"):
    """verify_matches over P pairs in one batched computation.

    pix1/pix2 (P, N, 2) padded putative pixel matches; mask (P, N);
    focal1/2 (P,); pp1/pp2 (P, 2); image_sizes (P, 2, 2) as
    [[w1, h1], [w2, h2]] per pair (zeros -> unscaled threshold), all
    host arrays. samples: a torch.Generator or VerificationSamples
    (P, H, 5) and (P, H, 4), on `device`.

    opts.guided_matching is honoured when the pairs' padded features
    are given (kp1_all/kp2_all (P, M, >=2) pixel keypoints,
    desc1/desc2 (P, M, D), fmask1/fmask2 (P, M)); the (M, M) band
    matrices are built for 2**27 // M**2 pairs at a time. dtype is the
    geometry's float type (float64 holds the exact eigenvector route of
    the five-point solver); descriptors stay float32.
    Returns (list of TwoViewInfo or None, list of corr (Mi, 4))."""
    opts = opts or GeometricVerificationOptions()
    ev = opts.estimate_twoview_info
    dev = samples_on(samples, device)
    P, maxm = np.asarray(pix1).shape[:2]
    f1 = np.asarray(focal1, float)
    f2 = np.asarray(focal2, float)
    pix1 = np.asarray(pix1, float)
    pix2 = np.asarray(pix2, float)
    x1 = (pix1 - np.asarray(pp1, float)[:, None]) / f1[:, None, None]
    x2 = (pix2 - np.asarray(pp2, float)[:, None]) / f2[:, None, None]
    thresh = ev.max_sampson_error_pixels ** 2 / (f1 * f2)
    sizes = np.asarray(image_sizes, float)
    scale = np.where(sizes.max(axis=2) > 0,
                     sizes.max(axis=2) / 1024.0, 1.0)   # (P, 2)
    h_thresh = (ev.max_sampson_error_pixels ** 2 *
                scale[:, 0] * scale[:, 1])

    def t(x, dt=dtype):
        return _tensor(x, dev).to(dt)
    mask_t = _tensor(mask, dev)
    if isinstance(samples, torch.Generator):
        samples = draw_verification_samples(samples, mask_t,
                                            ev.num_hypotheses)
    idx_e, idx_h = samples
    base = [t(x1), t(x2), t(pix1), t(pix2), mask_t, t(thresh),
            t(h_thresh), t(f1), t(f2), t(pp1), t(pp2)]
    guided = bool(opts.guided_matching and kp1_all is not None
                  and desc1 is not None)
    if guided:
        kp1_px = np.asarray(kp1_all, float)[:, :, :2]
        kp2_px = np.asarray(kp2_all, float)[:, :, :2]
        extra = [t(kp1_px), t(kp2_px), t(desc1, torch.float32),
                 t(desc2, torch.float32), _tensor(fmask1, dev),
                 _tensor(fmask2, dev)]
        # the guided stage builds (M, M) matrices per pair: chunk the
        # pairs so its temporaries stay near 1 GB
        M = kp1_px.shape[1]
        chunk = max(1, int(2 ** 27 // max(M * M, 1)))
    else:
        chunk = P
    outs = []
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        outs.append(_verify_chunk(
            idx_e[sl], idx_h[sl], *(a[sl] for a in base),
            opts.final_max_reprojection_error_pixels,
            opts.guided_matching_max_distance_pixels, ev.num_hypotheses,
            bool(opts.bundle_adjustment),
            guided=[e[sl] for e in extra] if guided else None))

    with record_function("verify.store"):
        aa, tt, R, keep, n_keep, n_h, gidx2 = (
            torch.cat([o[i] for o in outs], 0).cpu().numpy()
            for i in range(7))
        infos, corrs = [], []
        for p in range(P):
            if int(n_keep[p]) < opts.min_num_inlier_matches:
                infos.append(None)
                corrs.append(np.zeros((0, 4)))
                continue
            sel = keep[p][:maxm]
            c1 = pix1[p][sel]
            c2 = pix2[p][sel]
            if guided:
                gsel = keep[p][maxm:]
                if gsel.any():
                    c1 = np.concatenate([c1, kp1_px[p][gsel]])
                    c2 = np.concatenate([c2, kp2_px[p][gidx2[p][gsel]]])
            infos.append(TwoViewInfo(
                focal_length_1=float(f1[p]), focal_length_2=float(f2[p]),
                rotation_2=aa[p].astype(float),
                position_2=-R[p].T @ tt[p],
                num_verified_matches=int(n_keep[p]),
                num_homography_inliers=int(n_h[p]),
                visibility_score=visibility_score_of_inliers(
                    c1, c2, tuple(sizes[p, 0]), tuple(sizes[p, 1]))))
            corrs.append(np.concatenate([c1, c2], axis=1))
    return infos, corrs


@full_f32()
def verify_matches(samples, pix1, pix2, focal1, focal2, pp1, pp2,
                   opts: GeometricVerificationOptions = None,
                   kp1_all=None, kp2_all=None, desc1=None, desc2=None,
                   mask1=None, mask2=None,
                   image_size1=None, image_size2=None,
                   dtype=torch.float32, device="cuda"):
    """Verify putative matches between two calibrated views.

    pix1/pix2: (N, 2) putative match pixel coords. Optional kp/desc
    arrays enable guided matching over all features. samples: a
    torch.Generator or VerificationSamples (H, 5) and (H, 4) into the
    matches padded to a bucket of 64, on `device`. Returns (TwoViewInfo
    or None, inlier_correspondences (M, 4))."""
    opts = opts or GeometricVerificationOptions()
    ev = opts.estimate_twoview_info
    dev = samples_on(samples, device)
    pix1 = np.asarray(pix1, float)
    pix2 = np.asarray(pix2, float)
    if isinstance(samples, torch.Generator):
        # the estimators pad the matches to a bucket of 64
        n = len(pix1)
        samples = draw_verification_samples(
            samples, torch.arange(next_bucket(n, 64)) < n,
            ev.num_hypotheses)
    # 0. homography inlier count over the putative matches, before any
    # filtering (ref two_view_match_geometric_verification.cc:124)
    num_h = count_homography_inliers(
        samples.homography, pix1, pix2, ev.max_sampson_error_pixels,
        image_size1, image_size2, num_hypotheses=ev.num_hypotheses,
        dtype=dtype, device=dev)
    # 1. two-view estimation
    info, inliers = estimate_twoview_info(
        samples.essential, pix1, pix2, focal1, focal2, ev, pp1=pp1,
        pp2=pp2, dtype=dtype, device=dev)
    if info.num_verified_matches < opts.min_num_inlier_matches:
        return None, np.zeros((0, 4))
    corr1 = pix1[inliers]
    corr2 = pix2[inliers]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    R = rot.angle_axis_to_rotation_matrix(t(info.rotation_2))
    tv = -R @ t(info.position_2)
    # 2. guided matching over all features
    if opts.guided_matching and desc1 is not None:
        E = essential_from_rt(R, tv)
        F = fundamental_from_essential(E, focal1, focal2, t(pp1), t(pp2))
        n1, n2 = len(kp1_all), len(kp2_all)
        idx2, valid = guided_epipolar_matching(
            F, t(kp1_all[:, :2]), t(kp2_all[:, :2]),
            t(desc1, torch.float32), t(desc2, torch.float32),
            torch.ones(n1, dtype=torch.bool, device=dev) if mask1 is None
            else torch.as_tensor(np.asarray(mask1), device=dev),
            torch.ones(n2, dtype=torch.bool, device=dev) if mask2 is None
            else torch.as_tensor(np.asarray(mask2), device=dev),
            torch.zeros(n1, dtype=torch.bool, device=dev),
            torch.zeros(n2, dtype=torch.bool, device=dev),
            band_pixels=opts.guided_matching_max_distance_pixels)
        sel = np.nonzero(valid.cpu().numpy())[0]
        if len(sel):
            corr1 = np.concatenate([corr1, kp1_all[sel, :2]])
            corr2 = np.concatenate(
                [corr2, kp2_all[idx2.cpu().numpy()[sel], :2]])

    # normalized coords
    x1 = (corr1 - np.asarray(pp1)) / focal1
    x2 = (corr2 - np.asarray(pp2)) / focal2

    # 3-4. two-view BA, then triangulate
    tv = tv / torch.clamp(torch.linalg.norm(tv), min=1e-12)
    if opts.bundle_adjustment and len(x1) >= 8:
        aa_new, tv = bundle_adjust_two_views_angular(
            rot.rotation_matrix_to_angle_axis(R), tv, t(x1), t(x2),
            torch.ones(len(x1), dtype=dtype, device=dev))
        R = rot.angle_axis_to_rotation_matrix(aa_new)

    # 5. final filter: triangulate + reprojection gate
    P2 = torch.cat([R, tv[:, None]], dim=1)
    X = tri.triangulate_dlt(torch.eye(3, 4, dtype=dtype, device=dev), P2,
                            t(x1), t(x2)).cpu().numpy()
    aa_out = rot.rotation_matrix_to_angle_axis(R).cpu().numpy()
    R = R.cpu().numpy()
    tv = tv.cpu().numpy()
    w = X[:, 3:]
    w = np.where(np.abs(w) < 1e-12, 1e-12, w)
    Xc1 = X[:, :3] / w
    Xc2 = Xc1 @ R.T + tv
    ok = (Xc1[:, 2] > 1e-6) & (Xc2[:, 2] > 1e-6)
    r1 = np.linalg.norm(
        Xc1[:, :2] / np.maximum(Xc1[:, 2:], 1e-9) - x1, axis=1) * focal1
    r2 = np.linalg.norm(
        Xc2[:, :2] / np.maximum(Xc2[:, 2:], 1e-9) - x2, axis=1) * focal2
    thresh = opts.final_max_reprojection_error_pixels
    keep = ok & (r1 < thresh) & (r2 < thresh)
    if keep.sum() < opts.min_num_inlier_matches:
        return None, np.zeros((0, 4))

    out = TwoViewInfo(
        focal_length_1=float(focal1), focal_length_2=float(focal2),
        rotation_2=aa_out,
        position_2=-R.T @ tv,
        num_verified_matches=int(keep.sum()),
        num_homography_inliers=int(num_h),
        visibility_score=visibility_score_of_inliers(
            corr1[keep], corr2[keep], image_size1, image_size2))
    return out, np.concatenate([corr1[keep], corr2[keep]], axis=1)
