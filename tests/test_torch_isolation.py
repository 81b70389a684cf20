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
