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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureMatcher(FeatureMatcherOptions(
            perform_geometric_verification=False),
            features_db_from_arrays({}))
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
