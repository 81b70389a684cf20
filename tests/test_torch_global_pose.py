"""The port's global pose estimation (theiasfm_tpu_torch/sfm/global_pose/,
the rotation helpers and the camera rays) against the JAX package's, on
the CPU in float64 (the suite's x64), from the same numpy inputs.

Tolerances: the rotation helpers and the rays 1e-12; the MST
orientations 1e-12; robust, nonlinear and linear rotation averaging on a
20-view graph with 5% outlier edges 1e-9 rad (the angle between the two
packages' rotations); the view-graph filters, the cycle filter, the
rigid subgraph and the MFAS orders identical; the LUD, nonlinear and
linear-triplet positions 1e-8 of the scene's scale (the
scene of tests/test_linear_position.py); the triplet baseline ratios
1e-12. JAX's `_mfas_order` is held by both of its routes: the native
routine (native/host_ops.cc) and its Python fallback."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.camera import models as jcm
from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm import global_pose as jgp
from theiasfm_tpu.sfm.global_pose import cycle_filter as jcf
from theiasfm_tpu.sfm.global_pose import filters as jfi
from theiasfm_tpu.sfm.global_pose import linear_position as jlp
from theiasfm_tpu.sfm.global_pose import position_estimation as jpe
from theiasfm_tpu.sfm.global_pose import rigid_subgraph as jrs
from theiasfm_tpu.sfm.view_graph import TwoViewInfo as JTwoViewInfo
from theiasfm_tpu.sfm.view_graph import ViewGraph as JViewGraph
from theiasfm_tpu_torch.camera import models as tcm
from theiasfm_tpu_torch.convert import reconstruction_from_state
from theiasfm_tpu_torch.math import rotation as trot
from theiasfm_tpu_torch.sfm import global_pose as tgp
from theiasfm_tpu_torch.sfm.global_pose import cycle_filter as tcf
from theiasfm_tpu_torch.sfm.global_pose import filters as tfi
from theiasfm_tpu_torch.sfm.global_pose import linear_position as tlp
from theiasfm_tpu_torch.sfm.global_pose import position_estimation as tpe
from theiasfm_tpu_torch.sfm.global_pose import rigid_subgraph as trs
from theiasfm_tpu_torch.sfm.view_graph import TwoViewInfo
from theiasfm_tpu_torch.sfm.view_graph import ViewGraph

from test_linear_position import _make_scene
from torch_sfm_cases import one_torch_thread  # noqa: F401

CPU = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _angle_between(aa_a, aa_b):
    """Radians between two stacks of angle-axis rotations (float64; the
    angle of R_b R_a^T through the quaternion, exact near zero where
    arccos of the trace is not)."""
    return np.linalg.norm(trot.relative_rotation(_t(aa_a), _t(aa_b)).numpy(),
                          axis=-1)


# ---------------------------------------------------------------- helpers

def _angle_axes(n=64, seed=0):
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=(n, 3))
    aa *= rng.uniform(0, 3.1, size=(n, 1)) / np.linalg.norm(aa, axis=1,
                                                            keepdims=True)
    aa[:4] *= 1e-8            # the small-angle branch
    return aa


HELPERS = {
    "quaternion_to_rotation_matrix": lambda m, a, b: m.quaternion_to_rotation_matrix(
        m.angle_axis_to_quaternion(a)),
    "angle_axis_to_quaternion": lambda m, a, b: m.angle_axis_to_quaternion(a),
    "multiply_rotations": lambda m, a, b: m.multiply_rotations(a, b),
    "quaternion_multiply": lambda m, a, b: m.quaternion_multiply(
        m.angle_axis_to_quaternion(a), m.angle_axis_to_quaternion(b)),
    "relative_rotation": lambda m, a, b: m.relative_rotation(a, b),
    "rotation_angle_deg": lambda m, a, b: m.rotation_angle_deg(a),
    "rotation_error_deg": lambda m, a, b: m.rotation_error_deg(a, b)
    * np.pi / 180,
    "project_to_rotation_matrix": lambda m, a, b: m.project_to_rotation_matrix(
        m.angle_axis_to_rotation_matrix(a) + 0.05 *
        m.angle_axis_to_rotation_matrix(b)),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_rotation_helpers_match_jax(name):
    a, b = _angle_axes(seed=0), _angle_axes(seed=1)
    got = np.asarray(HELPERS[name](trot, _t(a), _t(b)))
    want = np.asarray(HELPERS[name](jrot, _j(a), _j(b)))
    if name == "rotation_error_deg":
        # arccos near 0: compare the rotations' separation, not the bits
        a, b = a[4:], b[4:]
        got = got[4:]
        want = want[4:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _intrinsics(model):
    intr = np.zeros(10)
    intr[:5] = [600.0, 1.1, 0.5, 320.0, 240.0]
    extra = {tcm.CameraModelType.PINHOLE: [0.05, -0.01],
             tcm.CameraModelType.PINHOLE_RADIAL_TANGENTIAL:
                 [0.05, -0.01, 0.002, 1e-3, -5e-4],
             tcm.CameraModelType.FISHEYE: [0.02, -0.01, 0.003, -1e-3],
             tcm.CameraModelType.FOV: [0.75],
             tcm.CameraModelType.DIVISION_UNDISTORTION: [-0.05]}[model]
    intr[5:5 + len(extra)] = extra
    return intr


@pytest.mark.parametrize("model", list(tcm.NUM_PARAMS),
                         ids=lambda m: m.name)
def test_rays_match_jax(model):
    rng = np.random.default_rng(int(model))
    intr = _intrinsics(model)
    pixel = rng.uniform([0, 0], [640, 480], size=(40, 2))
    extr = np.concatenate([rng.normal(size=3), 0.3 * rng.normal(size=3)])
    got = tcm.pixel_to_normalized_ray(model, _t(intr), _t(pixel)).numpy()
    want = np.asarray(jcm.pixel_to_normalized_ray(model, _j(intr),
                                                  _j(pixel)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tcm._remove_calibration(_t(intr), _t(pixel)).numpy(),
        np.asarray(jcm._remove_calibration(_j(intr), _j(pixel))),
        rtol=0, atol=1e-12)
    # undistort inverts distort
    np.testing.assert_allclose(
        tcm.distort(model, _t(intr), torch.from_numpy(got)).numpy(),
        tcm._remove_calibration(_t(intr), _t(pixel)).numpy(), atol=1e-10)
    go, gd = tcm.pixel_to_world_ray(model, _t(extr), _t(intr), _t(pixel))
    wo, wd = jcm.pixel_to_world_ray(model, _j(extr), _j(intr), _j(pixel))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=1e-12)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-12)


# ----------------------------------------------------- rotation averaging

def _rotation_graph(V=20, hops=4, outlier_frac=0.05, noise_deg=0.5, seed=3):
    """A ring of V views, each linked to its `hops` successors, with
    relative rotations R_ij = R_j R_i^T (noise_deg of noise) and a share
    of outlier edges (random rotations). Inputs in numpy."""
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=(V, 3)) * 0.8
    R = trot.angle_axis_to_rotation_matrix(_t(aa)).numpy()
    edges = np.array([(i, (i + h) % V) for i in range(V)
                      for h in range(1, hops + 1)])
    rel = trot.rotation_matrix_to_angle_axis(_t(
        R[edges[:, 1]] @ np.swapaxes(R[edges[:, 0]], 1, 2))).numpy()
    noise = rng.normal(size=rel.shape)
    noise *= np.radians(noise_deg) / np.linalg.norm(noise, axis=1,
                                                    keepdims=True)
    rel = trot.multiply_rotations(_t(noise), _t(rel)).numpy()
    out = rng.uniform(size=len(edges)) < outlier_frac
    out[:2] = True
    rel[out] = rng.normal(size=(out.sum(), 3))
    weights = rng.integers(30, 300, size=len(edges)).astype(float)
    return aa, edges, rel, weights, out


def test_orientations_from_mst_match_jax():
    _, edges, rel, w, _ = _rotation_graph()
    got = tgp.orientations_from_mst(20, edges, rel, w)
    want = jgp.orientations_from_mst(20, edges, rel, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("estimator", ["robust", "nonlinear", "linear"])
def test_rotation_averaging_matches_jax(estimator):
    truth, edges, rel, w, out = _rotation_graph()
    init = jgp.orientations_from_mst(20, edges, rel, w)
    if estimator == "robust":
        got = tgp.robust_rotation_averaging(init, edges, rel, **CPU)
        want = jgp.robust_rotation_averaging(init, edges, rel)
    elif estimator == "nonlinear":
        got = tgp.nonlinear_rotation_averaging(init, edges, rel, **CPU)
        want = jgp.nonlinear_rotation_averaging(init, edges, rel)
    else:
        got = tgp.linear_rotation_averaging(20, edges, rel, w, **CPU)
        want = jgp.linear_rotation_averaging(20, edges, rel, w)
    assert _angle_between(got, want).max() < 1e-9
    # and near the truth (up to the gauge), so the comparison is not void:
    # the robust estimator within 1 degree, the plain least squares ones
    # pulled by the outlier edges
    R = trot.angle_axis_to_rotation_matrix(_t(got)).numpy()
    Rt = trot.angle_axis_to_rotation_matrix(_t(truth)).numpy()
    G = R[0].T @ Rt[0]
    err = _angle_between(
        trot.rotation_matrix_to_angle_axis(_t(R @ G)).numpy(), truth)
    bound = {"robust": 1, "nonlinear": 3, "linear": 10}[estimator]
    assert np.median(err) < np.radians(bound)


def test_orientation_filter_matches_jax():
    _, edges, rel, w, out = _rotation_graph()
    init = jgp.orientations_from_mst(20, edges, rel, w)
    orient = jgp.robust_rotation_averaging(init, edges, rel)
    got = tfi.filter_view_pairs_from_orientation(orient, edges, rel, 5.0,
                                                 **CPU)
    want = jfi.filter_view_pairs_from_orientation(orient, edges, rel, 5.0)
    np.testing.assert_array_equal(got, want)
    assert got[out].sum() < out.sum() / 2
    assert 0.8 * len(edges) < got.sum() < len(edges)


def _translation_graph(V=24, hops=5, outlier_frac=0.1, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, size=(V, 3))
    orient = 0.4 * rng.normal(size=(V, 3))
    R = trot.angle_axis_to_rotation_matrix(_t(orient)).numpy()
    edges = np.array([(i, (i + h) % V) for i in range(V)
                      for h in range(1, hops + 1)])
    d = np.einsum("eij,ej->ei", R[edges[:, 0]],
                  pos[edges[:, 1]] - pos[edges[:, 0]])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d += rng.normal(scale=0.01, size=d.shape)
    out = rng.uniform(size=len(edges)) < outlier_frac
    d[out] = rng.normal(size=(out.sum(), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orient, edges, d, pos, out


def test_relative_translation_filter_matches_jax():
    orient, edges, d, _, out = _translation_graph()
    got = tfi.filter_view_pairs_from_relative_translation(
        orient, edges, d, seed=3, **CPU)
    want = jfi.filter_view_pairs_from_relative_translation(
        orient, edges, d, seed=3)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(edges) and not got[out].all()


def _arcs(kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        n = 40
        i = rng.integers(0, n, 300)
        j = rng.integers(0, n, 300)
        keep = i != j
        return n, i[keep], j[keep], rng.uniform(0, 1, keep.sum())
    # tied scores: a directed cycle of equal weights (no source, every
    # score 0), a second cycle, and equal-weight sources
    n = 12
    i = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10])
    j = np.array([1, 2, 3, 0, 5, 6, 7, 4, 0, 4, 1, 5])
    w = np.array([0.5] * 8 + [0.25, 0.25, 0.25, 0.25])
    return n, i, j, w


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", ["random", "tied"])
def test_mfas_order_matches_jax(route, kind, monkeypatch):
    from theiasfm_tpu.utils import native
    n, i, j, w = _arcs(kind)
    if route == "native":
        assert native.mfas_order_native(n, i, j, w) is not None
    else:
        monkeypatch.setattr(native, "mfas_order_native",
                            lambda *a, **k: None)
    want = jfi._mfas_order(n, i, j, w)
    got = tfi._mfas_order(n, i, j, w)
    np.testing.assert_array_equal(got, want)
    assert sorted(got) == list(range(n))


def _both_graphs(edges, rel, d=None):
    jg, tg = JViewGraph(), ViewGraph()
    for e, (a, b) in enumerate(edges):
        f = dict(rotation_2=rel[e], num_verified_matches=100,
                 position_2=np.zeros(3) if d is None else d[e])
        jg.add_edge(int(a), int(b), JTwoViewInfo(**f))
        tg.add_edge(int(a), int(b), TwoViewInfo(**f))
    return jg, tg


def test_cycle_filter_matches_jax():
    _, edges, rel, _, out = _rotation_graph(outlier_frac=0.15)
    jg, tg = _both_graphs(edges, rel)
    n_t = tcf.filter_view_graph_cycles_by_rotation(tg, 3.0, **CPU)
    n_j = jcf.filter_view_graph_cycles_by_rotation(jg, 3.0)
    assert n_t == n_j > 0
    assert sorted(tg.edges()) == sorted(jg.edges())


# --------------------------------------------------------------- positions

def _scale(gt):
    return np.linalg.norm(gt - gt[0], axis=1).max()


def _aligned(est, gt):
    """est's positions scaled onto gt's (both with camera 0 at the
    origin), as test_linear_position's _position_error aligns them."""
    gt, est = gt - gt[0], est - est[0]
    return est * np.sum(gt * est) / max(np.sum(est * est), 1e-12), gt


@pytest.mark.parametrize("estimator", ["lud", "nonlinear"])
def test_positions_match_jax(estimator):
    _, _, orient, edges, rel_pos, gt = _make_scene()
    w = np.linspace(0.5, 1.0, len(edges))
    got = getattr(tgp, f"estimate_positions_{estimator}")(
        orient, edges, rel_pos, edge_weights=w, **CPU)
    want = getattr(jgp, f"estimate_positions_{estimator}")(
        orient, edges, rel_pos, edge_weights=w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * _scale(gt))
    est, g = _aligned(got, gt)
    assert np.abs(est - g).max() < 1e-6 * _scale(gt)


def _port_recon(jrec):
    return reconstruction_from_state(
        {"views": {v: dataclasses.asdict(x) for v, x in jrec.views.items()},
         "tracks": {t: dataclasses.asdict(x)
                    for t, x in jrec.tracks.items()},
         "view_groups": dict(jrec.view_groups)})


@pytest.mark.parametrize("path", ["dense", "inverse_power"])
def test_linear_triplet_positions_match_jax(path):
    jrec, vids, orient, edges, rel_pos, gt = _make_scene(N=80, noise_px=0.5)
    kw = {} if path == "dense" else dict(dense_threshold=1)
    got, gcov = tlp.estimate_positions_linear_triplet(
        _port_recon(jrec), vids, orient, edges, rel_pos,
        tlp.LinearPositionOptions(**kw), **CPU)
    want, wcov = jlp.estimate_positions_linear_triplet(
        jrec, vids, orient, edges, rel_pos, jlp.LinearPositionOptions(**kw))
    np.testing.assert_array_equal(gcov, wcov)
    assert gcov.all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * _scale(gt))


def test_triplet_baseline_ratios_match_jax():
    rng = np.random.default_rng(7)
    T, K = 6, 32
    R = trot.angle_axis_to_rotation_matrix(
        _t(0.1 * rng.normal(size=(3, T, 3)))).numpy()
    p = rng.normal(size=(3, T, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    f = rng.normal(size=(3, T, K, 3)) + np.array([0, 0, 4.0])
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mask = rng.uniform(size=(T, K)) < 0.8
    args = [*R, *p, *f]
    gb, gv = tlp.compute_triplet_baseline_ratios(
        *[_t(a) for a in args], torch.from_numpy(mask))
    jb, jv = jlp.compute_triplet_baseline_ratios(
        *[_j(a) for a in args], jnp.asarray(mask))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-12)


# --------------------------------------------------------- rigid subgraph

def test_rigid_component_matches_jax():
    """Two rigid clusters joined by one hinge edge and a dangling view:
    the maximal parallel-rigid component is one cluster."""
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(9, 3)) * 3
    edges = [(a, b) for a in range(4) for b in range(a + 1, 4)] + \
        [(a, b) for a in range(4, 8) for b in range(a + 1, 8)] + \
        [(3, 4), (7, 8)]
    edges = np.array(edges)
    d = pos[edges[:, 1]] - pos[edges[:, 0]]
    got = trs.maximal_rigid_component(edges, d, 9)
    want = jrs.maximal_rigid_component(edges, d, 9)
    np.testing.assert_array_equal(got, want)
    assert 4 <= len(got) < 9


def test_rigid_subgraph_extraction_matches_jax():
    orient, edges, d, _, _ = _translation_graph(V=10, hops=2,
                                                outlier_frac=0.0)
    jg, tg = _both_graphs(edges, np.zeros((len(edges), 3)), d)
    o = {v: orient[v] for v in range(10)}
    n_t = trs.extract_maximally_parallel_rigid_subgraph(o, tg)
    n_j = jrs.extract_maximally_parallel_rigid_subgraph(o, jg)
    assert n_t == n_j
    assert tg.view_ids() == jg.view_ids()
    assert sorted(tg.edges()) == sorted(jg.edges())


# ------------------------------------------------------------------ misc

def test_sharded_forms_raise_naming_slice_e():
    """The device solvers' sharded forms (slice E) raise, naming the axis,
    when no mesh binds axis_name (never a silent single-device solve)."""
    x = torch.zeros((3, 3), dtype=torch.float64)
    i = torch.tensor([0, 1])
    with pytest.raises(LookupError, match="'edges' is not bound"):
        tgp.rotation_averaging._rotation_averaging_device(
            x, i, i, x[:2], torch.ones(2, dtype=torch.float64),
            tgp.RobustRotationOptions(), 3, axis_name="edges")
    with pytest.raises(LookupError, match="'edges' is not bound"):
        tpe._solve_positions(x, i, i, x[:2], torch.ones(2),
                             tgp.PositionEstimatorOptions(), 3, "lud",
                             axis_name="edges")


def _split_edges(r, n, *arrays):
    """Rank r's contiguous share of each edge array, as tensors."""
    k = -(-len(arrays[0]) // n)
    return [torch.as_tensor(a[r * k:(r + 1) * k]) for a in arrays]


def test_sharded_device_solvers_match_single_device():
    """_rotation_averaging_device and _solve_positions with axis_name on 2
    thread ranks, each with its half of the edges, against the same
    solvers on all the edges (float64; short schedules: every CG
    iteration is an all-reduce)."""
    from torch_parallel_cases import run_threads

    truth, edges, rel, w, _ = _rotation_graph()
    init = _t(jgp.orientations_from_mst(20, edges, rel, w))
    ropts = tgp.RobustRotationOptions(l1_iterations=2, irls_iterations=2,
                                      cg_iterations=20)
    ones = np.ones(len(edges))
    ei, ej = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    want_r = tgp.rotation_averaging._rotation_averaging_device(
        init, *_split_edges(0, 1, ei, ej, rel, ones), ropts, 20)

    pos = np.random.default_rng(1).normal(size=(20, 3))
    t_world = pos[ej] - pos[ei]
    t_world /= np.linalg.norm(t_world, axis=1, keepdims=True)
    c0 = _t(pos + 0.1 * np.random.default_rng(2).normal(size=pos.shape))
    popts = tgp.PositionEstimatorOptions(max_iterations=5, cg_iterations=20)
    want_p = tpe._solve_positions(c0, *_split_edges(0, 1, ei, ej, t_world,
                                                    ones), popts, 20, "lud")

    def body(ranks):
        mesh = ranks.mesh("edges")
        with mesh.bind():
            r = tgp.rotation_averaging._rotation_averaging_device(
                init, *_split_edges(ranks.rank, 2, ei, ej, rel, ones),
                ropts, 20, axis_name="edges")
            p = tpe._solve_positions(
                c0, *_split_edges(ranks.rank, 2, ei, ej, t_world, ones),
                popts, 20, "lud", axis_name="edges")
        return r.numpy(), p.numpy()

    for r, p in run_threads(body, 2):
        np.testing.assert_allclose(r, want_r.numpy(), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(p, want_p.numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_lud_convex_matches_jax():
    """_solve_positions_lud_convex (the device BCD of the convex LUD)
    against JAX's in float64."""
    _, edges, rel, w, _ = _rotation_graph()
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(20, 3)) * 3.0
    t_world = pos[edges[:, 1]] - pos[edges[:, 0]]
    t_world /= np.linalg.norm(t_world, axis=1, keepdims=True)
    init = rng.normal(size=(20, 3))
    opts = dict(max_iterations=30, cg_iterations=20)
    want = jpe._solve_positions_lud_convex(
        jnp.asarray(init), jnp.asarray(edges[:, 0]),
        jnp.asarray(edges[:, 1]), jnp.asarray(t_world), jnp.asarray(w),
        jgp.PositionEstimatorOptions(**opts), 20)
    got = tpe._solve_positions_lud_convex(
        _t(init), torch.as_tensor(edges[:, 0]), torch.as_tensor(edges[:, 1]),
        _t(t_world), _t(w), tgp.PositionEstimatorOptions(**opts), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


def test_exports_and_options_match_jax():
    import theiasfm_tpu.sfm.global_pose as jmod
    jnames = {n for n in dir(jmod) if not n.startswith("_")}
    tnames = {n for n in dir(tgp) if not n.startswith("_")}
    assert jnames - {"annotations"} <= tnames
    for name in ("RobustRotationOptions", "PositionEstimatorOptions",
                 "LinearPositionOptions"):
        assert dataclasses.asdict(getattr(tgp, name)()) == \
            dataclasses.asdict(getattr(jgp, name)())
    assert dataclasses.asdict(tfi.RelativeTranslationFilterOptions()) == \
        dataclasses.asdict(jfi.RelativeTranslationFilterOptions())
