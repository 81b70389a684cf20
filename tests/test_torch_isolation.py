"""The port stands alone: no module of theiasfm_tpu_torch (nor
chip_smoke.py) imports JAX or the JAX package, the package imports and
solves with JAX unimportable, importing it builds nothing, and its
constructors refuse to fall back to the CPU."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "theiasfm_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "theiasfm_tpu"}


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and
              getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args and
              isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = set(_imported_roots(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


def test_runs_without_jax():
    """Import the package with jax and theiasfm_tpu unimportable and run
    a 2-iteration BA on the CPU, through both matvec paths; nothing is
    built or loaded."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import dataclasses
        import torch
        from theiasfm_tpu_torch import _kernels
        from theiasfm_tpu_torch.bench_problem import make_problem
        from theiasfm_tpu_torch.sfm.ba import BAOptions, bundle_adjust
        from theiasfm_tpu_torch.sfm.ba.bundle_adjustment import (
            add_pallas_matvec_plan, pad_obs_to_multiple)
        p = make_problem(8, 64, 3, dtype=torch.float32, device="cpu")
        p = add_pallas_matvec_plan(pad_obs_to_multiple(p, 256), 256)
        o = BAOptions(max_iterations=2, cg_iterations=10, loss="huber",
                      loss_scale=2.0)
        for kw in ({}, {"pallas_matvec": True, "matvec_bf16": True}):
            _, s = bundle_adjust(p, dataclasses.replace(o, **kw))
            assert s.num_iterations == 2
            assert float(s.final_cost) < float(s.initial_cost)
        assert _kernels.build.cache_info().currsize == 0
        assert _kernels.library.cache_info().currsize == 0
        assert not any(m == "jax" or m.startswith(("jax.", "theiasfm_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_make_problem_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from theiasfm_tpu_torch.bench_problem import make_problem
    from theiasfm_tpu_torch.convert import from_jax_arrays
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_problem(4, 16, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_arrays({})


def test_frontend_entry_points_raise_without_card():
    """SIFT and the feature matcher default to the card and refuse to
    fall back to the CPU; top2 refuses a device that is neither."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np
    from theiasfm_tpu_torch.convert import features_db_from_arrays
    from theiasfm_tpu_torch.image import extract_sift, extract_sift_batch
    from theiasfm_tpu_torch.matching import (FeatureMatcher,
                                             FeatureMatcherOptions)
    from theiasfm_tpu_torch.matching.fused_matcher import top2
    img = np.zeros((32, 32), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_sift(img)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_sift_batch([img, img])
    for opts in (FeatureMatcherOptions(),
                 FeatureMatcherOptions(perform_geometric_verification=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FeatureMatcher(opts, features_db_from_arrays({}))
    d = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="got meta"):
        top2(d, d, torch.zeros((1, 4), device="meta"))


def test_frontend_runs_without_jax():
    """With jax and theiasfm_tpu unimportable: SIFT on two small views
    and the feature matcher on the CPU; nothing is built or loaded."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import numpy as np
        from theiasfm_tpu_torch import _kernels
        from theiasfm_tpu_torch.convert import features_db_from_arrays
        from theiasfm_tpu_torch.image import (SiftOptions,
                                              extract_sift_batch,
                                              render_synthetic_views)
        from theiasfm_tpu_torch.matching import (FeatureMatcher,
                                                 FeatureMatcherOptions)
        rng = np.random.default_rng(0)
        views, _ = render_synthetic_views(rng.random((64, 64)), 2,
                                          (96, 80), focal=90.0)
        res = extract_sift_batch(views, SiftOptions(
            num_octaves=2, max_features_per_octave=128), device="cpu")
        db = features_db_from_arrays({f"v{i}": (k[v], d[v]) for
                                      i, (k, d, v) in enumerate(res)})
        fm = FeatureMatcher(FeatureMatcherOptions(
            perform_geometric_verification=False,
            min_num_feature_matches=1), db, device="cpu")
        fm.add_images(["v0", "v1"])
        assert fm.match_images() == 1
        assert _kernels.build.cache_info().currsize == 0
        assert not any(m == "jax" or m.startswith(("jax.", "theiasfm_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_verification_runs_without_jax():
    """With jax and theiasfm_tpu unimportable: the batched geometric
    verification and the single-pair path on a synthetic pair on the
    CPU, from a generator; nothing is built or loaded."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import numpy as np
        import torch
        from theiasfm_tpu_torch import _kernels
        from theiasfm_tpu_torch.sfm.pipeline import (
            GeometricVerificationOptions, TwoViewInfoOptions,
            verify_matches, verify_matches_batch)
        rng = np.random.default_rng(0)
        pts = rng.uniform([-2, -2, 4], [2, 2, 10], size=(120, 3))
        p2 = pts + np.array([1.0, 0.1, 0.0])
        pix1 = pts[:, :2] / pts[:, 2:] * 600 + 320
        pix2 = p2[:, :2] / p2[:, 2:] * 600 + 320
        o = GeometricVerificationOptions(
            estimate_twoview_info=TwoViewInfoOptions(num_hypotheses=32))
        g = torch.Generator().manual_seed(0)
        infos, corrs = verify_matches_batch(
            g, pix1[None], pix2[None], np.ones((1, 120), bool),
            np.full(1, 600.0), np.full(1, 600.0), np.full((1, 2), 320.0),
            np.full((1, 2), 320.0), np.zeros((1, 2, 2)), o, device="cpu")
        n = infos[0].num_verified_matches
        assert n >= 110 and len(corrs[0]) == n
        info, _ = verify_matches(g, pix1, pix2, 600.0, 600.0, (320, 320),
                                 (320, 320), o, device="cpu")
        assert info.num_verified_matches >= 110
        assert _kernels.build.cache_info().currsize == 0
        assert not any(m == "jax" or m.startswith(("jax.", "theiasfm_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_verification_entry_points_raise_without_card():
    """The verification's entry points default to the card and refuse
    to fall back to the CPU; samples on another device than the call's
    raise."""
    import numpy as np
    from theiasfm_tpu_torch.sfm.pipeline import (
        TwoViewInfoOptions, count_homography_inliers, estimate_twoview_info,
        estimate_twoview_info_batch, verify_matches, verify_matches_batch)
    pix = np.zeros((1, 64, 2))
    one, pp = np.ones(1), np.zeros((1, 2))
    calls = [
        lambda g, **k: verify_matches_batch(
            g, pix, pix, np.ones((1, 64), bool), one, one, pp, pp,
            np.zeros((1, 2, 2)), **k),
        lambda g, **k: verify_matches(g, pix[0], pix[0], 1.0, 1.0,
                                      (0, 0), (0, 0), **k),
        lambda g, **k: estimate_twoview_info(g, pix[0], pix[0], 1.0, 1.0,
                                             TwoViewInfoOptions(), **k),
        lambda g, **k: estimate_twoview_info_batch(
            g, pix, pix, np.ones((1, 64), bool), one, one, pp, pp,
            TwoViewInfoOptions(), **k),
        lambda g, **k: count_homography_inliers(g, pix[0], pix[0], 2.25,
                                                **k)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(torch.Generator())
        with pytest.raises(ValueError, match="samples on cpu"):
            call(torch.Generator(), device="meta")


def test_reconstruction_entry_points_raise_without_card():
    """The snapshot and the reconstruction-level entry points default to
    the card and refuse to fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from theiasfm_tpu_torch.sfm.ba import (bundle_adjust_reconstruction,
                                           bundle_adjust_view)
    from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
    rec = Reconstruction()
    vid = rec.add_view("v0")
    rec.views[vid].is_estimated = True
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.to_ba_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust_reconstruction(rec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust_view(rec, vid)


def test_rest_of_ba_runs_without_jax():
    """With jax and theiasfm_tpu unimportable: a reconstruction built
    through add_view/add_track/add_observation, bundle_adjust_reconstruction
    with the blocks kernel options, the dense-Schur solve, the f64 solve
    and the two-view refinements, all on the CPU; nothing is built or
    loaded."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import numpy as np
        import torch
        from theiasfm_tpu_torch import _kernels
        from theiasfm_tpu_torch.bench_problem import make_problem
        from theiasfm_tpu_torch.sfm.ba import (BAOptions,
                                               bundle_adjust_reconstruction)
        from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba
        from theiasfm_tpu_torch.sfm.ba import two_view
        from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
        p = make_problem(8, 300, 4, dtype=torch.float32, device="cpu")
        rec = Reconstruction()
        for i in range(8):
            v = rec.add_view(f"v{i}", group=0)
            rec.views[v].camera.extrinsics = p.extrinsics[i].double().numpy()
            rec.views[v].camera.intrinsics = p.intrinsics[0].double().numpy()
            rec.views[v].is_estimated = True
        for j in range(300):
            t = rec.add_track()
            rec.tracks[t].point = np.append(p.points[j].double().numpy(), 1)
            rec.tracks[t].is_estimated = True
        for m in np.flatnonzero(p.obs_mask.numpy()):
            rec.add_observation(int(p.obs_cam[m]), int(p.obs_pt[m]),
                                p.obs_pix[m].double().numpy())
        s = bundle_adjust_reconstruction(rec, BAOptions(
            max_iterations=3, loss="huber", loss_scale=2.0,
            pallas_matvec=True, pallas_blocks=True), device="cpu")
        assert s["final_cost"] < s["initial_cost"], s
        q = ba.add_point_obs_map(p)
        o = BAOptions(max_iterations=2, linear_solver="dense_schur")
        _, s = ba.bundle_adjust(q, o)
        assert float(s.final_cost) < float(s.initial_cost)
        out, s = ba.bundle_adjust_host_f64(p, BAOptions(max_iterations=2))
        assert out.points.dtype == torch.float64
        R = torch.eye(3, dtype=torch.float64)[None]
        x = torch.rand(1, 10, 2, dtype=torch.float64)
        w = torch.ones(1, 10, dtype=torch.float64)
        t = two_view.optimize_relative_position_with_known_rotation(
            torch.tensor([[1.0, 0, 0]], dtype=torch.float64), R, R, x, x, w)
        assert t.shape == (1, 3)
        assert _kernels.build.cache_info().currsize == 0
        assert not any(m == "jax" or m.startswith(("jax.", "theiasfm_tpu."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# A 6-view synthetic scene handed to the port's builder as injected
# matches (code run in a subprocess with JAX unimportable):
# `builder(options)` returns a ReconstructionBuilder on the CPU with the
# scene's views, features and true pairwise geometry.
_SIX_VIEWS = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "theiasfm_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    from theiasfm_tpu_torch import _kernels
    from theiasfm_tpu_torch.convert import features_db_from_arrays
    from theiasfm_tpu_torch.math import rotation as rot
    from theiasfm_tpu_torch.matching import ImagePairMatch
    from theiasfm_tpu_torch.sfm.reconstruction_builder import (
        ReconstructionBuilder, ReconstructionBuilderOptions)
    from theiasfm_tpu_torch.sfm.view_graph import TwoViewInfo
    torch.set_num_threads(1)   # small tensors; the suite runs in parallel
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.5, 2.5, size=(100, 3))
    Rs, cs, obs = [], [], []
    for v in range(6):
        a = 0.9 * (v / 5 - 0.5)
        c = np.array([8 * np.sin(a), 0.3 * rng.normal(),
                      -8 * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        pc = (pts - c) @ R.T
        obs.append(700 * pc[:, :2] / pc[:, 2:] + 400 +
                   rng.normal(scale=0.3, size=(100, 2)))
        Rs.append(R)
        cs.append(c)
    names = [f"v{v}" for v in range(6)]
    descriptors = {n: rng.random((100, 128)).astype(np.float32)
                   for n in names}

    def builder(options, dtype=torch.float32):
        db = features_db_from_arrays(
            {n: (np.concatenate([o, np.ones((100, 2))], 1), descriptors[n])
             for n, o in zip(names, obs)},
            {n: dict(image_width=800, image_height=800, focal_length=700.0,
                     principal_point=(400.0, 400.0)) for n in names})
        b = ReconstructionBuilder(options, db, dtype=dtype, device="cpu")
        for i in range(6):
            for j in range(i + 1, 6):
                pos = Rs[i] @ (cs[j] - cs[i])
                aa = rot.rotation_matrix_to_angle_axis(
                    torch.from_numpy(Rs[j] @ Rs[i].T)).numpy()
                info = TwoViewInfo(position_2=pos / np.linalg.norm(pos),
                                   rotation_2=aa, num_verified_matches=100)
                b.add_two_view_match(names[i], names[j], ImagePairMatch(
                    names[i], names[j], info,
                    np.concatenate([obs[i], obs[j]], 1)))
        return b
""")

_NOTHING_BUILT = textwrap.dedent("""
    assert _kernels.build.cache_info().currsize == 0
    assert not any(m == "jax" or m.startswith(("jax.", "theiasfm_tpu."))
                   for m, v in sys.modules.items() if v is not None)
    print("ok")
""")


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_builder_runs_without_jax():
    """With jax and theiasfm_tpu unimportable: the reconstruction
    builder from injected matches of a 6-view synthetic scene, the
    INCREMENTAL estimator on the CPU (P3P localization, track
    estimation, BA, filters), and the Fisher-vector extractor; nothing
    is built or loaded."""
    _run(_SIX_VIEWS + textwrap.dedent("""
        from theiasfm_tpu_torch.matching.fisher_vector import (
            FisherVectorExtractor, FisherVectorOptions)
        models = builder(ReconstructionBuilderOptions(
            reconstruction_estimator_type="INCREMENTAL")
        ).build_reconstruction()
        assert len(models) == 1, models
        assert len(models[0].estimated_views()) == 6
        assert len(models[0].estimated_tracks()) > 80
        fv = FisherVectorExtractor(FisherVectorOptions(num_gmm_clusters=2,
                                                       em_iterations=2),
                                   device="cpu")
        fv.train(rng.random((50, 8)))
        assert np.isfinite(fv.extract_global_descriptor(
            rng.random((10, 8)))).all()
    """) + _NOTHING_BUILT)


@pytest.mark.parametrize("kind", ["GLOBAL", "HYBRID"])
def test_global_and_hybrid_builders_run_without_jax(kind):
    """With jax and theiasfm_tpu unimportable: the builder's default
    options (GLOBAL: rotation averaging, the view-graph filters, LUD
    positions, triangulation, BA) and HYBRID, from the 6-view scene's
    injected matches on the CPU; nothing is built or loaded. GLOBAL
    builds in float64: in float32 its LUD lands 2% of the scene from the
    float64 positions on this low-noise scene and no track passes the
    5 px gate, in JAX's float32 build too (ROADMAP queue 3)."""
    _run(_SIX_VIEWS + textwrap.dedent(f"""
        options = ReconstructionBuilderOptions() if "{kind}" == "GLOBAL" \
            else ReconstructionBuilderOptions(
                reconstruction_estimator_type="{kind}")
        assert options.reconstruction_estimator_type == "{kind}"
        dtype = torch.float64 if "{kind}" == "GLOBAL" else torch.float32
        models = builder(options, dtype).build_reconstruction()
        assert len(models) == 1, models
        assert len(models[0].estimated_views()) == 6
        assert len(models[0].estimated_tracks()) > 80
    """) + _NOTHING_BUILT)


def test_global_entry_points_raise_without_card():
    """The global and hybrid pipelines and the modules they build on
    default to the card and refuse to fall back to the CPU; on the CPU
    when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np
    from theiasfm_tpu_torch.sfm import global_pose as gp
    from theiasfm_tpu_torch.sfm.global_pose.cycle_filter import (
        filter_view_graph_cycles_by_rotation)
    from theiasfm_tpu_torch.sfm.pipeline import (
        GlobalOptions, HybridOptions, LocalizeOptions, global_reconstruction,
        hybrid_reconstruction)
    from theiasfm_tpu_torch.sfm.pipeline.hybrid import (
        localize_views_known_orientation_batch)
    from theiasfm_tpu_torch.sfm.pipeline.select_good_tracks import (
        select_good_tracks_for_bundle_adjustment)
    from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
    from theiasfm_tpu_torch.sfm.reconstruction_builder import (
        ReconstructionBuilder, ReconstructionBuilderOptions)
    from theiasfm_tpu_torch.sfm.view_graph import ViewGraph
    from theiasfm_tpu_torch.solvers import exhaustive_pair_samples
    rec = Reconstruction()
    rec.add_view("v0")
    edges = np.array([[0, 1], [1, 2], [0, 2]])
    aa = np.zeros((3, 3))
    g = torch.Generator()
    calls = [
        lambda **k: global_reconstruction(rec, ViewGraph(), GlobalOptions(),
                                          **k),
        lambda **k: hybrid_reconstruction(rec, ViewGraph(), HybridOptions(),
                                          **k),
        lambda **k: gp.robust_rotation_averaging(aa, edges, aa, **k),
        lambda **k: gp.linear_rotation_averaging(3, edges, aa, **k),
        lambda **k: gp.filter_view_pairs_from_orientation(aa, edges, aa,
                                                          **k),
        lambda **k: gp.filter_view_pairs_from_relative_translation(
            aa, edges, np.eye(3), **k),
        lambda **k: gp.estimate_positions_lud(aa, edges, np.eye(3), **k),
        lambda **k: gp.estimate_positions_nonlinear(aa, edges, np.eye(3),
                                                    **k),
        lambda **k: filter_view_graph_cycles_by_rotation(ViewGraph(), **k),
        lambda **k: localize_views_known_orientation_batch(
            g, rec, [0], LocalizeOptions(), **k),
        lambda **k: select_good_tracks_for_bundle_adjustment(rec, **k),
        lambda **k: exhaustive_pair_samples(4, 8, **k),
        lambda **k: ReconstructionBuilder(ReconstructionBuilderOptions(),
                                          **k),
        lambda **k: ReconstructionBuilder(ReconstructionBuilderOptions(
            reconstruction_estimator_type="HYBRID"), **k)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in calls:
        call(device="cpu")


def test_incremental_entry_points_raise_without_card():
    """The incremental pipeline, the localization and the builder (and
    the modules they build on: track estimation, the filters, the
    Fisher-vector extractor, the feature extractor) default to the card
    and refuse to fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from theiasfm_tpu_torch.matching.fisher_vector import (
        FisherVectorExtractor)
    from theiasfm_tpu_torch.sfm.feature_extractor import FeatureExtractor
    from theiasfm_tpu_torch.sfm.pipeline import (
        EstimateTracksOptions, IncrementalOptions, LocalizeOptions,
        estimate_all_tracks, incremental_reconstruction, localize_view,
        set_outlier_tracks_to_unestimated)
    from theiasfm_tpu_torch.sfm.pipeline.localize import (
        localize_views_batch)
    from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction
    from theiasfm_tpu_torch.sfm.reconstruction_builder import (
        ReconstructionBuilder, ReconstructionBuilderOptions)
    from theiasfm_tpu_torch.sfm.view_graph import ViewGraph
    rec = Reconstruction()
    rec.add_view("v0")
    g = torch.Generator()
    calls = [
        lambda: incremental_reconstruction(rec, ViewGraph()),
        lambda: localize_views_batch(g, rec, [0], LocalizeOptions()),
        lambda: localize_view(g, rec, 0, LocalizeOptions()),
        lambda: estimate_all_tracks(rec, EstimateTracksOptions()),
        lambda: set_outlier_tracks_to_unestimated(rec),
        lambda: ReconstructionBuilder(ReconstructionBuilderOptions()),
        lambda: FisherVectorExtractor(),
        lambda: FeatureExtractor()]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # on the CPU when asked
    assert incremental_reconstruction(rec, ViewGraph(), IncrementalOptions(),
                                      device="cpu")["success"] is False
    assert localize_views_batch(g, rec, [0], LocalizeOptions(),
                                device="cpu") == {}
    ReconstructionBuilder(ReconstructionBuilderOptions(), device="cpu")
