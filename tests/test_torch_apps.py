"""The port's CLIs (theiasfm_tpu_torch/apps) against the JAX package's
(apps/), on the CPU.

* The options: for three argv lists, `options_from_args` gives the
  ReconstructionBuilderOptions JAX's CLI builds, field by field (JAX's
  are captured by a stub builder that records them and raises).
* One end-to-end run: `python -m theiasfm_tpu_torch.apps.
  build_reconstruction --device cpu` as a subprocess on 6 small PNG views
  that image/synth.py renders; JAX's reader reads the npz it writes to
  the port's reading, and convert_reconstruction turns it into a Theia
  .bin that JAX's Python parser reads.
* No CPU fallback: `--device cuda` without a card exits non-zero.
* The CPU rehearsal of chip_smoke.py's `io_cli` phase on that run's
  database (the CPU's brute force counted as the card's two top2_match
  launches per chunk)."""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import theiasfm_tpu.io as jio
import theiasfm_tpu_torch.io as tio
from theiasfm_tpu_torch.apps import build_reconstruction as br
from theiasfm_tpu_torch.apps import convert_reconstruction as cr
from theiasfm_tpu_torch.sfm.reconstruction_builder import (
    ReconstructionBuilderOptions)
from test_torch_io import assert_recons_agree

REPO = Path(__file__).resolve().parents[1]
BASE = ["--images", "unused/*.png", "--output_reconstruction", "unused/m"]
ARGVS = {
    "defaults": [],
    "incremental_cascade": [
        "--reconstruction_estimator", "INCREMENTAL", "--matching_strategy",
        "cascade_hashing", "--lowes_ratio", "0.7",
        "--keep_only_symmetric_matches", "0",
        "--min_num_inliers_for_valid_match", "20",
        "--absolute_pose_reprojection_error_threshold", "6",
        "--min_num_absolute_pose_inliers", "25",
        "--partial_bundle_adjustment_num_views", "10",
        "--bundle_adjust_tracks", "0", "--intrinsics_to_optimize", "ALL"],
    "hybrid_fisher": [
        "--reconstruction_estimator", "HYBRID",
        "--select_image_pairs_with_global_image_descriptor_matching",
        "--num_nearest_neighbors_for_global_descriptor_matching", "8",
        "--num_gmm_clusters_for_fisher_vector", "8",
        "--feature_density", "DENSE", "--intrinsics_to_optimize", "NONE",
        "--global_position_estimator", "LINEAR_TRIPLET",
        "--global_rotation_estimator", "NONLINEAR",
        "--bundle_adjustment_robust_loss_function", "HUBER",
        "--subsample_tracks_for_bundle_adjustment",
        "--extract_maximal_rigid_subgraph",
        "--filter_relative_translations_with_1dsfm", "0"],
}


def _flat(o):
    return {f.name: (_flat(getattr(o, f.name))
                     if dataclasses.is_dataclass(getattr(o, f.name))
                     else getattr(o, f.name))
            for f in dataclasses.fields(o)}


class _Captured(Exception):
    pass


def _jax_cli_options(argv, monkeypatch):
    """The options apps/build_reconstruction.py builds for argv: its
    ReconstructionBuilder is replaced by a stub that records them and
    raises."""
    from theiasfm_tpu.sfm import reconstruction_builder as jrb
    spec = importlib.util.spec_from_file_location(
        "jax_build_reconstruction", REPO / "apps" / "build_reconstruction.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}

    def stub(options, db=None):
        seen["options"] = options
        raise _Captured

    monkeypatch.setattr(jrb, "ReconstructionBuilder", stub)
    monkeypatch.setattr(sys, "argv", ["build_reconstruction.py", *argv])
    with pytest.raises(_Captured):
        mod.main()
    return seen["options"]


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_options_from_args_match_jax(case, monkeypatch):
    argv = BASE + ARGVS[case]
    port = br.options_from_args(br.build_parser().parse_args(argv))
    jax_opts = _jax_cli_options(argv, monkeypatch)
    assert _flat(port) == _flat(jax_opts)


def test_io_cli_flags_give_global_24_options():
    """chip_smoke.IO_CLI_FLAGS make the CLI's options equal, field by
    field, the ones `global_24` builds with (the defaults of
    ReconstructionBuilderOptions and Fisher-vector pairs, 8 neighbours);
    without the four flags beyond the pair selection the two differ."""
    import chip_smoke as cs
    want = ReconstructionBuilderOptions(
        select_image_pairs_with_global_descriptors=True,
        num_nearest_neighbors_for_global_descriptor_matching=8)
    got = br.options_from_args(br.build_parser().parse_args(
        BASE + list(cs.IO_CLI_FLAGS)))
    assert _flat(got) == _flat(want)
    assert br.options_from_args(br.build_parser().parse_args(
        BASE + list(cs.IO_CLI_FLAGS[:3]))) != want


def _write_views(d, n=6):
    """6 renderings of 200x150 (focal 190) of image/synth.py's scene."""
    from PIL import Image
    from theiasfm_tpu_torch.image import render_synthetic_views
    rng = np.random.default_rng(0)
    views, cams = render_synthetic_views(rng.random((256, 256)), n,
                                         (200, 150), focal=190.0)
    d.mkdir()
    for i, im in enumerate(views):
        Image.fromarray((im * 255).astype(np.uint8)).save(d / f"v{i}.png")
    return cams


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CLI, as a user runs it, on the CPU: INCREMENTAL on the
    6 views with SPARSE features, its database on disk."""
    tmp = tmp_path_factory.mktemp("cli")
    cams = _write_views(tmp / "images")
    cmd = [sys.executable, "-m",
           "theiasfm_tpu_torch.apps.build_reconstruction", "--device", "cpu",
           "--reconstruction_estimator", "INCREMENTAL",
           "--feature_density", "SPARSE",
           "--images", str(tmp / "images" / "*.png"),
           "--matching_working_directory", str(tmp / "db"),
           "--output_reconstruction", str(tmp / "out" / "model")]
    out = subprocess.run(cmd, cwd=tmp, env=_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return tmp, cams, out.stdout


def test_cli_writes_a_model_jax_reads(cli_run):
    tmp, _, stdout = cli_run
    assert "built 1 model(s)" in stdout
    npz = tmp / "out" / "model-0.npz"
    port, jax_read = tio.read_reconstruction(str(npz)), \
        jio.read_reconstruction(str(npz))
    assert len(port.estimated_views()) >= 4
    assert len(port.estimated_tracks()) >= 50
    assert_recons_agree(port, jax_read)


def test_convert_reconstruction_to_theia_jax_reads(cli_run, capsys):
    tmp, _, _ = cli_run
    npz, out = tmp / "out" / "model-0.npz", tmp / "out" / "model.bin"
    assert cr.main(["--input", str(npz), "--output", str(out),
                    "--output_format", "theia"]) == 0
    assert "wrote theia" in capsys.readouterr().out
    recon = tio.read_reconstruction(str(npz))
    assert_recons_agree(jio.read_theia_reconstruction(
        str(out), prefer_native=False), tio.read_theia_reconstruction(
        str(out), prefer_native=False))
    for v in recon.views:
        np.testing.assert_array_equal(
            jio.read_theia_reconstruction(str(out), prefer_native=False)
            .views[v].camera.extrinsics, recon.views[v].camera.extrinsics)


def test_cli_without_card_fails_at_once(tmp_path):
    """--device cuda (the default) without a card exits non-zero with
    resolve_device's message: no CPU fallback."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "theiasfm_tpu_torch.apps.build_reconstruction",
         "--images", str(tmp_path / "*.png"), "--output_reconstruction",
         str(tmp_path / "m")], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_io_cli_rehearsal_on_cpu(cli_run, monkeypatch):
    """chip_smoke.phase_io_cli on the CPU on the end-to-end run's
    features (3 of the 6 views): the CLI in-process with the phase's
    flags (INCREMENTAL) and --device cpu, the npz, .bin, NVM and bundler
    checks. On the CPU the brute force launches no kernel, so each
    chunk's batch matcher counts the card's two top2_match launches."""
    import chip_smoke as cs
    from theiasfm_tpu_torch.matching import DiskFeaturesAndMatchesDatabase
    from theiasfm_tpu_torch.matching import feature_matcher as tfmod
    from theiasfm_tpu_torch.utils import count_dispatch

    tmp, cams, _ = cli_run
    db = DiskFeaturesAndMatchesDatabase(str(tmp / "db"))
    names = sorted(db.image_names_of_features())[:3]
    scene = dict(names=names, cams=cams, arrays={
        n: (db.get_features(n).keypoints, db.get_features(n).descriptors)
        for n in names}, priors={n: dict(
            image_width=200, image_height=150, focal_length=190.0,
            principal_point=(100.0, 75.0)) for n in names})
    real = tfmod.match_descriptors_batch

    def counted(*a, **k):
        count_dispatch("top2_match", 2)
        return real(*a, **k)
    monkeypatch.setattr(tfmod, "match_descriptors_batch", counted)
    def sync_time(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    monkeypatch.setattr(cs, "sync_time", sync_time)
    monkeypatch.setattr(cs, "nvidia_smi", lambda: "cpu")
    monkeypatch.setattr(cs, "_view_index", lambda n: int(n[1:-4]))
    lines = []
    monkeypatch.setattr(cs, "emit", lambda phase, **f: lines.append(f))
    # GLOBAL in float32 builds no model on so few small views (ROADMAP
    # queue 3): the rehearsal reconstructs with INCREMENTAL
    monkeypatch.setattr(cs, "IO_CLI_FLAGS", cs.IO_CLI_FLAGS + (
        "--reconstruction_estimator", "INCREMENTAL"))
    monkeypatch.setattr(cs, "GLOBAL24_OPTIONS", dataclasses.replace(
        cs.GLOBAL24_OPTIONS, reconstruction_estimator_type="INCREMENTAL"))
    n_top2 = cs.phase_io_cli(scene, device="cpu", gate=(1.0, 1.0))
    res = lines[-1]
    assert n_top2 == res["top2_match"] == 2 * res["chunks"] > 0
    assert res["views_estimated"] >= 3
    assert set(res["io_ms"]) >= {"npz_read", "theia_read_native",
                                 "theia_read_python", "nvm_read",
                                 "bundler_read"}
    assert max(res["rotation_derived_max_rel"].values()) <= 1e-9
