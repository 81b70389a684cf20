"""The port's sfm/transformation.py, sfm/utils.py and sfm/undistort.py
against the JAX package's, in float64 on the CPU.

* align_point_clouds and align_reconstructions_robust are numpy float64
  copies with the same random draws: equal results (to 1e-12).
* align_rotations: the closed-form jacobian equals jax.jacfwd of JAX's
  residual to 1e-10 (measured 3e-16) and the aligned rotations equal
  JAX's to 1e-10 (test_linear_position.py:126's case).
* transform_reconstruction and alignment_and_pose_errors on the same
  reconstruction in both packages: equal to 1e-12 relative.
* undistort_points / undistort_image / undistort_reconstruction in
  float64 against JAX under x64: points to 1e-9 px, images to 1e-12
  (measured at most 7.1e-15 and 2.2e-13); in float32 the image is within
  F32_TOL of JAX's float64 one (values in [0, 1]). The port's division
  model takes its root in a form that does not cancel in float32
  (camera/models._distort_division), so there its float32 image is
  closer to the float64 one than JAX's float32 image is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sfm_cases as cases
from theiasfm_tpu.camera.models import CameraModelType as JModel
from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm import transformation as jtr
from theiasfm_tpu.sfm import undistort as jund
from theiasfm_tpu.sfm import utils as jutils
from theiasfm_tpu.sfm.reconstruction import Camera as JCamera
from theiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from theiasfm_tpu_torch.camera.models import CameraModelType as TModel
from theiasfm_tpu_torch.math import rotation as trot
from theiasfm_tpu_torch.sfm import transformation as ttr
from theiasfm_tpu_torch.sfm import undistort as tund
from theiasfm_tpu_torch.sfm import utils as tutils
from theiasfm_tpu_torch.sfm.reconstruction import Camera as TCamera
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction as TRecon

from torch_sfm_cases import one_torch_thread  # noqa: F401


def _similarity(rng):
    R = cases.rotation(rng.uniform(-1, 1, 3))
    return 1.7, R, rng.normal(size=3)


def test_align_point_clouds_and_robust_equal_jax(rng):
    s, R, t = _similarity(rng)
    src = rng.normal(size=(30, 3))
    dst = s * src @ R.T + t + rng.normal(scale=1e-3, size=(30, 3))
    dst[:4] += rng.normal(scale=5.0, size=(4, 3))        # gross outliers
    for fn in ("align_point_clouds", "align_reconstructions_robust"):
        ours = getattr(ttr, fn)(src, dst)
        theirs = getattr(jtr, fn)(src, dst)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    s2, R2, t2 = ttr.align_reconstructions_robust(src, dst)
    np.testing.assert_allclose(R2, R, atol=1e-3)
    assert abs(s2 - s) < 1e-3


def test_align_rotations_jacobian_equals_jacfwd(rng):
    R_un = cases.rotation(rng.uniform(-1, 1, 3))[None] @ \
        np.stack([cases.rotation(a) for a in rng.uniform(-1, 1, (6, 3))])
    gt = rng.uniform(-1, 1, (6, 3))
    x = rng.uniform(-1, 1, 3)

    def residuals(x):
        R = jnp.einsum("nij,jk->nik", jnp.asarray(R_un),
                       jrot.angle_axis_to_rotation_matrix(x))
        return (jrot.rotation_matrix_to_angle_axis(R) - gt).reshape(-1)
    J = np.asarray(jax.jacfwd(residuals)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    a = trot.rotation_matrix_to_angle_axis(
        torch.from_numpy(R_un) @ trot.angle_axis_to_rotation_matrix(xt))
    Jt = (ttr._aa_jacobian_right(a) @ ttr._right_jacobian(xt)
          ).reshape(-1, 3).numpy()
    np.testing.assert_allclose(Jt, J, atol=1e-10)
    # and at a tiny angle (the Taylor branches)
    x = np.array([1e-6, -2e-6, 5e-7])
    J = np.asarray(jax.jacfwd(residuals)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    a = trot.rotation_matrix_to_angle_axis(
        torch.from_numpy(R_un) @ trot.angle_axis_to_rotation_matrix(xt))
    Jt = (ttr._aa_jacobian_right(a) @ ttr._right_jacobian(xt)
          ).reshape(-1, 3).numpy()
    np.testing.assert_allclose(Jt, J, atol=1e-10)


def test_align_rotations_matches_jax():
    """tests/test_linear_position.py:126's case."""
    rng = np.random.default_rng(7)
    gt = rng.uniform(-1, 1, (20, 3))
    R_align = cases.rotation([0.3, -0.2, 0.5])
    R_gt = np.stack([cases.rotation(g) for g in gt])
    unaligned = np.stack([cases.angle_axis(R) for R in R_gt @ R_align.T])
    ours = ttr.align_rotations(gt, unaligned, device="cpu")
    np.testing.assert_allclose(ours, jtr.align_rotations(gt, unaligned),
                               atol=1e-10)
    err = [float(trot.rotation_error_deg(torch.from_numpy(a),
                                         torch.from_numpy(g)))
           for a, g in zip(ours, gt)]
    assert max(err) < 1e-4


def _both_estimated(rng):
    sc = cases.scene(rng, n_views=6, n_pts=60)
    jrec, trec = cases.reconstructions(sc)
    for rec in (jrec, trec):
        cases.set_true_state(sc, rec)
    return sc, jrec, trec


def test_transform_reconstruction_matches_jax(rng):
    _, jrec, trec = _both_estimated(rng)
    s, R, t = _similarity(rng)
    jtr.transform_reconstruction(jrec, s, R, t)
    ttr.transform_reconstruction(trec, s, R, t)
    for v in jrec.views:
        np.testing.assert_allclose(trec.views[v].camera.extrinsics,
                                   jrec.views[v].camera.extrinsics,
                                   rtol=1e-12, atol=1e-12)
    for k in jrec.tracks:
        np.testing.assert_allclose(trec.tracks[k].point,
                                   jrec.tracks[k].point, rtol=1e-12)


def test_alignment_and_pose_errors_match_jax(rng):
    sc, jrec, trec = _both_estimated(rng)
    # the estimate: the truth under a similarity, with noise and one
    # view far off
    s, R, t = _similarity(rng)
    for rec, mod in ((jrec, jtr), (trec, ttr)):
        mod.transform_reconstruction(rec, s, R, t)
    g = np.random.default_rng(3)
    noise = g.normal(scale=0.01, size=(sc.n_views, 6))
    noise[2, :3] += 5.0
    for rec in (jrec, trec):
        for v in rec.views:
            rec.views[v].camera.extrinsics += noise[v]
    jref, tref = JRecon(), TRecon()
    for rec in (jref, tref):
        for v in range(sc.n_views):
            vid = rec.add_view(f"img{v}.jpg")
            rec.views[vid].camera.extrinsics = sc.extrinsics[v].copy()
            rec.views[vid].is_estimated = True
    ours = tutils.alignment_and_pose_errors(trec, tref)
    theirs = jutils.alignment_and_pose_errors(jrec, jref)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert ours[0][2] > 1.0 and np.median(ours[0]) < 0.1


def test_sfm_utils_match_jax():
    """tests/test_data_model.py:128's case, both packages."""
    out = []
    for Recon, mod in ((JRecon, jutils), (TRecon, tutils)):
        r = Recon()
        v1, v2, v3 = [r.add_view(f"u{i}.jpg") for i in range(3)]
        t1, t2 = r.add_track(), r.add_track()
        r.add_observation(v1, t1, (0, 0))
        r.add_observation(v2, t1, (1, 1))
        r.add_observation(v2, t2, (2, 2))
        r.add_observation(v3, t2, (3, 3))
        r2 = Recon()
        r2.add_view("u1.jpg")
        r2.add_view("zz.jpg")
        out.append((mod.find_common_tracks_in_views(r, [v1, v2]),
                    mod.find_common_tracks_in_views(r, [v1, v3]),
                    mod.find_common_tracks_in_views(r, []),
                    mod.find_common_views_by_name(r, r2)))
    assert out[0] == out[1] == ([t1], [], [], ["u1.jpg"])


# the port's float32 image against JAX's float64 map: measured 3.4e-6 to
# 4.7e-6 over the five models (JAX's own float32 map: the same, but
# 2.7e-4 for the division model, whose root cancels in JAX's float32)
F32_TOL = 1e-5
CAMERAS = [("PINHOLE", [0.05, 0.01]),
           ("PINHOLE_RADIAL_TANGENTIAL", [-0.2, 0.05, 0.0, 1e-3, -2e-3]),
           ("FISHEYE", [0.02, -0.01, 0.0, 0.0]),
           ("FOV", [0.6]),
           ("DIVISION_UNDISTORTION", [-0.2])]


def _cameras(model, params, size=(64, 48)):
    out = []
    for Cam, Model in ((JCamera, JModel), (TCamera, TModel)):
        cam = Cam()
        cam.model_type = getattr(Model, model)
        cam.intrinsics[:5] = [0.9 * size[0], 1.0, 0.0, size[0] / 2,
                              size[1] / 2]
        cam.intrinsics[5:5 + len(params)] = params
        cam.image_width, cam.image_height = size
        out.append(cam)
    return out


@pytest.mark.parametrize("model,params", CAMERAS, ids=[c[0] for c in CAMERAS])
def test_undistort_points_and_image_match_jax(model, params, rng):
    jcam, tcam = _cameras(model, params)
    pts = rng.uniform((0, 0), (63, 47), size=(50, 2))
    np.testing.assert_allclose(
        tund.undistort_points(tcam, pts, torch.float64, device="cpu"),
        jund.undistort_points(jcam, pts), atol=1e-9)
    img = rng.random((48, 64)).astype(np.float32)
    theirs = jund.undistort_image(jcam, img)
    ours = tund.undistort_image(tcam, img, torch.float64, device="cpu")
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, atol=1e-12)
    # colour images take the same weights per channel
    rgb = rng.random((48, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tund.undistort_image(tcam, rgb, torch.float64, device="cpu"),
        jund.undistort_image(jcam, rgb), atol=1e-12)
    # float32 against JAX's float64 map
    ours = tund.undistort_image(tcam, img, device="cpu")
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=F32_TOL)
    if model == "DIVISION_UNDISTORTION":
        # JAX's float32 map (float32 intrinsics, as without x64) loses
        # the division model's root to cancellation; the port's keeps it
        jcam.intrinsics = np.asarray(jcam.intrinsics, np.float32)
        assert np.abs(jund.undistort_image(jcam, img) - theirs).max() > \
            10 * F32_TOL


def test_undistort_reconstruction_and_colorize_match_jax():
    recs = [JRecon(), TRecon()]
    jcam, tcam = _cameras("PINHOLE", [0.05, 0.01], (640, 480))
    for rec, cam in zip(recs, (jcam, tcam)):
        v = rec.add_view("a.jpg")
        rec.views[v].camera = cam
        for p in ((100.0, 100.0), (500.0, 60.0)):
            t = rec.add_track()
            rec.add_observation(v, t, p)
    jund.undistort_reconstruction(recs[0])
    tund.undistort_reconstruction(recs[1], torch.float64, device="cpu")
    for t in recs[0].tracks:
        np.testing.assert_allclose(recs[1].views[0].features[t],
                                   recs[0].views[0].features[t], atol=1e-9)
    assert not np.any(recs[1].views[0].camera.intrinsics[5:])
    assert recs[1].views[0].camera.model_type == TModel.PINHOLE
    img = np.random.default_rng(1).random((480, 640, 3))
    for rec, mod in zip(recs, (jund, tund)):
        mod.colorize_reconstruction(rec, lambda name: img)
    for t in recs[0].tracks:
        np.testing.assert_array_equal(recs[1].tracks[t].color,
                                      recs[0].tracks[t].color)


def test_division_model_root_matches_jax_and_keeps_float32():
    """camera/models._distort_division against JAX's in float64 (1e-12,
    also beyond the model's range with k > 0, where both clamp), and in
    float32 within 1e-6 of the float64 root near the centre, where JAX's
    float32 form cancels (measured: the port 1.2e-10, JAX 1.5e-4 to
    4.0e-4; float64 agreement 5.2e-13)."""
    from theiasfm_tpu.camera import models as jcm
    from theiasfm_tpu_torch.camera import models as tcm
    g = np.random.default_rng(0)
    xy = np.concatenate([g.uniform(-1e-3, 1e-3, (50, 2)),
                         g.uniform(-0.8, 0.8, (50, 2)),
                         g.uniform(1.5, 3.0, (20, 2))])
    for k in (-0.2, 0.3):
        intr = np.zeros(10)
        intr[[0, 1, 5]] = 1.0, 1.0, k
        theirs = np.asarray(jcm._distort_division(jnp.asarray(intr),
                                                  jnp.asarray(xy)))
        ours = tcm._distort_division(torch.from_numpy(intr),
                                     torch.from_numpy(xy)).numpy()
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
        near = xy[:50].astype(np.float32)
        f32 = tcm._distort_division(torch.from_numpy(intr).float(),
                                    torch.from_numpy(near)).numpy()
        assert np.abs(f32 - theirs[:50]).max() <= 1e-6
        jf32 = np.asarray(jcm._distort_division(
            jnp.asarray(intr, jnp.float32), jnp.asarray(near)))
        assert np.abs(jf32 - theirs[:50]).max() > 1e-5
