"""The port's reconstruction model and reconstruction-level BA entry
points (theiasfm_tpu_torch/sfm/reconstruction.py, sfm/ba/entry_points.py)
against the JAX package's, on the scene of tests/test_ba_entry_points.py
built once in JAX and handed to the port with
convert.reconstruction_from_state.

The port snapshots in float64 here (`dtype=torch.float64`) because the
JAX package's snapshot is float64 under the suite's x64 mode; its own
default is float32. Tolerances are the JAX tests' (recovered pose and
point within 1e-5 of the truth, final cost below 1e-8, held blocks
untouched); the two packages' results agree to 1e-7."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm.ba import entry_points as jep
from theiasfm_tpu.sfm.reconstruction import CameraModelType
from theiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from theiasfm_tpu_torch.convert import reconstruction_from_state
from theiasfm_tpu_torch.sfm.ba import entry_points as tep

AGREE = 1e-7


def _make_recon(rng, V=6, N=80):
    """tests/test_ba_entry_points.py's scene: V views sharing one
    intrinsics group, N points at depth about 8, every point seen by
    every view without noise."""
    positions = rng.uniform(-1, 1, (V, 3))
    orient = rng.uniform(-0.1, 0.1, (V, 3))
    pts = rng.uniform(-2, 2, (N, 3))
    pts[:, 2] += 8.0
    recon = JRecon()
    vids, Rs = [], np.asarray(
        jrot.angle_axis_to_rotation_matrix(jnp.asarray(orient)))
    for i in range(V):
        vid = recon.add_view(f"v{i}", group=77)
        vids.append(vid)
        view = recon.views[vid]
        view.camera.model_type = CameraModelType.PINHOLE
        view.camera.intrinsics[0] = 600.0
        view.camera.intrinsics[3:5] = [320.0, 240.0]
        view.camera.extrinsics = np.concatenate([positions[i], orient[i]])
        view.is_estimated = True
    tids = []
    for p in pts:
        tid = recon.add_track()
        tids.append(tid)
        recon.tracks[tid].point = np.append(p, 1.0)
        recon.tracks[tid].is_estimated = True
    for i, vid in enumerate(vids):
        Xc = (Rs[i] @ (pts - positions[i]).T).T
        px = 600.0 * Xc[:, :2] / Xc[:, 2:3] + np.array([320.0, 240.0])
        for tid, p in zip(tids, px):
            recon.add_observation(vid, tid, p)
    return recon, vids, tids


def _state(recon):
    return {"views": {v: dataclasses.asdict(x)
                      for v, x in recon.views.items()},
            "tracks": {t: dataclasses.asdict(x)
                       for t, x in recon.tracks.items()},
            "view_groups": dict(recon.view_groups),
            "next_view_id": recon._next_view_id,
            "next_track_id": recon._next_track_id,
            "next_group_id": recon._next_group_id}


def _both(recon_j):
    return recon_j, reconstruction_from_state(_state(recon_j))


def _assert_recons_agree(rt, rj, atol):
    assert rt.views.keys() == rj.views.keys()
    assert rt.tracks.keys() == rj.tracks.keys()
    for v in rj.views:
        for k in ("extrinsics", "intrinsics"):
            np.testing.assert_allclose(getattr(rt.views[v].camera, k),
                                       getattr(rj.views[v].camera, k),
                                       atol=atol, rtol=0)
    for t in rj.tracks:
        np.testing.assert_allclose(rt.tracks[t].point, rj.tracks[t].point,
                                   atol=atol, rtol=0)


def test_reconstruction_from_state_copies_everything():
    rj, rt = _both(_make_recon(np.random.default_rng(42))[0])
    assert rt.view_groups == rj.view_groups
    assert rt.view_id_from_name("v3") == rj.view_id_from_name("v3")
    assert (rt._next_view_id, rt._next_track_id, rt._next_group_id) == (
        rj._next_view_id, rj._next_track_id, rj._next_group_id)
    for v in rj.views:
        a, b = rt.views[v], rj.views[v]
        assert a.name == b.name and a.is_estimated == b.is_estimated
        assert int(a.camera.model_type) == int(b.camera.model_type)
        assert a.features.keys() == b.features.keys()
        for t in b.features:
            np.testing.assert_array_equal(a.features[t], b.features[t])
    for t in rj.tracks:
        assert rt.tracks[t].views == rj.tracks[t].views
    _assert_recons_agree(rt, rj, atol=0)
    # the port's copy is its own: editing it leaves the JAX scene alone
    rt.views[0].camera.extrinsics[0] += 1.0
    assert rt.views[0].camera.extrinsics[0] != \
        rj.views[0].camera.extrinsics[0]


@pytest.mark.parametrize("kw", [{}, {"shared_intrinsics": False},
                                {"only_estimated": False,
                                 "track_subset": set(range(0, 80, 3))}],
                         ids=["default", "per_view", "subset"])
def test_to_ba_problem_round_trip_matches_jax(kw):
    rj, _ = _make_recon(np.random.default_rng(42))[:2]
    rj.tracks[4].is_estimated = False
    rj.views[5].is_estimated = False
    rj, rt = _both(rj)
    pj, mj = rj.to_ba_problem(**kw)
    pt, mt = rt.to_ba_problem(dtype=torch.float64, device="cpu", **kw)
    for name, a in pt._asdict().items():
        b = getattr(pj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    assert mt[:3] == tuple(mj[:3])
    np.testing.assert_array_equal(mt[3], mj[3])
    # fold a changed snapshot back into both
    g = np.random.default_rng(1)
    delta = [g.normal(size=x.shape) for x in (pt.extrinsics, pt.intrinsics,
                                               pt.points)]
    rj.update_from_ba(pj._replace(
        extrinsics=pj.extrinsics + delta[0],
        intrinsics=pj.intrinsics + delta[1],
        points=pj.points + delta[2]), mj)
    rt.update_from_ba(pt._replace(
        extrinsics=pt.extrinsics + torch.tensor(delta[0]),
        intrinsics=pt.intrinsics + torch.tensor(delta[1]),
        points=pt.points + torch.tensor(delta[2])), mt)
    _assert_recons_agree(rt, rj, atol=1e-12)


def test_to_ba_problem_float32_default():
    _, rt = _both(_make_recon(np.random.default_rng(42))[0])
    p, _ = rt.to_ba_problem(device="cpu")
    assert p.points.dtype == torch.float32
    assert p.obs_pix.dtype == torch.float32
    assert p.obs_cam.dtype == torch.int32


def test_bundle_adjust_view_matches_jax():
    rng = np.random.default_rng(42)
    rj, vids, _ = _make_recon(rng)
    v = vids[2]
    true_extr = rj.views[v].camera.extrinsics.copy()
    rj.views[v].camera.extrinsics = true_extr + rng.normal(0, 0.02, 6)
    rj, rt = _both(rj)
    others = {u: rt.views[u].camera.extrinsics.copy()
              for u in vids if u != v}
    sj = jep.bundle_adjust_view(rj, v)
    st = tep.bundle_adjust_view(rt, v, device="cpu", dtype=torch.float64)
    assert st["final_cost"] < 1e-8, st
    np.testing.assert_allclose(rt.views[v].camera.extrinsics, true_extr,
                               atol=1e-5)
    for u, e in others.items():
        np.testing.assert_allclose(rt.views[u].camera.extrinsics, e)
    assert st["num_iterations"] == sj["num_iterations"]
    _assert_recons_agree(rt, rj, atol=AGREE)


def test_bundle_adjust_track_matches_jax():
    rng = np.random.default_rng(42)
    rj, vids, tids = _make_recon(rng)
    t = tids[5]
    true_pt = rj.tracks[t].point.copy()
    rj.tracks[t].point = true_pt + np.array([0.05, -0.03, 0.08, 0.0])
    rj, rt = _both(rj)
    cams = {u: rt.views[u].camera.extrinsics.copy() for u in vids}
    jep.bundle_adjust_track(rj, t)
    st = tep.bundle_adjust_track(rt, t, device="cpu", dtype=torch.float64)
    assert st["final_cost"] < 1e-8, st
    np.testing.assert_allclose(rt.tracks[t].xyz(), true_pt[:3], atol=1e-5)
    for u, e in cams.items():
        np.testing.assert_allclose(rt.views[u].camera.extrinsics, e)
    _assert_recons_agree(rt, rj, atol=AGREE)


def test_bundle_adjust_partial_matches_jax():
    rng = np.random.default_rng(42)
    rj, vids, _ = _make_recon(rng)
    var_views = vids[3:]
    for u in var_views:
        rj.views[u].camera.extrinsics += rng.normal(0, 0.01, 6)
    rj, rt = _both(rj)
    fixed = {u: rt.views[u].camera.extrinsics.copy() for u in vids[:3]}
    sj = jep.bundle_adjust_partial_reconstruction(rj, var_views, None)
    st = tep.bundle_adjust_partial_reconstruction(
        rt, var_views, None, device="cpu", dtype=torch.float64)
    assert st["final_cost"] < st["initial_cost"]
    assert st["final_cost"] < 1e-6
    np.testing.assert_allclose(st["initial_cost"], sj["initial_cost"],
                               rtol=1e-12)
    for u, e in fixed.items():
        np.testing.assert_allclose(rt.views[u].camera.extrinsics, e)
    _assert_recons_agree(rt, rj, atol=AGREE)


@pytest.mark.parametrize("extra", [{}, {"pallas_matvec": True,
                                        "pallas_blocks": True}],
                         ids=["default", "pallas_blocks"])
def test_bundle_adjust_reconstruction_matches_jax(extra, monkeypatch):
    """The default options, and the kernel options of pcg_fast_pblocks
    on a float32 snapshot of 200 points (1,200 observations, padded to
    2,048, so the bucketed solver attaches the plan and make_blocks goes
    through the blocks wrapper, which on the CPU runs its plain
    version), held to the JAX solve's final cost at rtol 1e-3 as the
    port's f32 configurations are."""
    rng = np.random.default_rng(42)
    rj, vids, tids = _make_recon(rng, N=200 if extra else 80)
    for u in vids[1:]:
        rj.views[u].camera.extrinsics += rng.normal(0, 0.005, 6)
    for t in tids:
        rj.tracks[t].point[:3] += rng.normal(0, 0.01, 3)
    rj, rt = _both(rj)
    if not extra:
        sj = jep.bundle_adjust_reconstruction(rj)
        st = tep.bundle_adjust_reconstruction(rt, device="cpu",
                                              dtype=torch.float64)
        assert st["final_cost"] < 1e-6, st
        np.testing.assert_allclose(st["initial_cost"], sj["initial_cost"],
                                   rtol=1e-12)
        _assert_recons_agree(rt, rj, atol=1e-6)
        return
    from theiasfm_tpu.sfm.ba import BAOptions as JOptions
    from theiasfm_tpu_torch.sfm.ba import BAOptions
    from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm
    calls = []
    blocks = fm.blocks
    monkeypatch.setattr(fm, "blocks", lambda *a, **k: calls.append(
        a[0].shape) or blocks(*a, **k))
    base = dict(max_iterations=10, loss="huber", loss_scale=2.0,
                function_tolerance=0.0, cg_iterations=60, **extra)
    sj = jep.bundle_adjust_reconstruction(rj, JOptions(**base))
    st = tep.bundle_adjust_reconstruction(rt, BAOptions(**base),
                                          device="cpu")
    assert calls and calls[0] == (2048, 12)
    assert st["final_cost"] < 0.5 * st["initial_cost"], st
    np.testing.assert_allclose(st["final_cost"], sj["final_cost"],
                               rtol=1e-3, atol=1e-6)
