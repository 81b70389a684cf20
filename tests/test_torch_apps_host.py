"""The port's host-side CLIs (theiasfm_tpu_torch/apps: the eight
converters and exporters, compare_reconstructions,
compute_reconstruction_statistics, compute_matching_relative_pose_errors,
view_reconstruction) against the JAX package's (apps/) on the same
files, on the CPU; every new module run as `python -m`; the `--device`
CLIs failing at once without a card.

The inputs: tests/test_torch_io.make_recons' 5-view model (one view not
estimated, a radial-tangential camera, some tracks not estimated)
written by the port's io. Tolerances: printouts with the same text and
numbers within 1e-9 relative (host float64), within 1e-4 plus one
printed unit for the float32 reprojection errors; written files byte
for byte where no rotation is computed, within 1e-12 relative where
one is (tests/test_torch_io.py's rule)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import theiasfm_tpu.io as jio
import theiasfm_tpu_torch.io as tio
from theiasfm_tpu_torch.matching.database import (
    DiskFeaturesAndMatchesDatabase, ImagePairMatch)
from theiasfm_tpu_torch.sfm.view_graph import TwoViewInfo
from test_torch_io import (REL, _features, _rotation, assert_recons_agree,
                           assert_text_agrees, make_recons)
from torch_apps_cases import (DEVICE_REL, HOST_REL, REPO,
                              assert_same_printout, port_cli, run_jax,
                              run_port)
from torch_sfm_cases import one_torch_thread  # noqa: F401

NEW_CLIS = sorted(
    p.stem for p in (REPO / "apps").glob("*.py")
    if p.stem not in ("build_reconstruction", "convert_reconstruction"))
DEVICE_CLIS = {
    "extract_features": ["--input_images", "x/*.png",
                         "--features_output_directory", "x"],
    "compute_two_view_geometry": ["--image1", "x.png", "--image2", "y.png"],
    "calibrate_camera_intrinsics": ["--images", "x/*.png"],
    "build_1dsfm_reconstruction": ["--1dsfm_dataset_directory", "x",
                                   "--output_reconstruction", "x.npz"],
    "evaluate_relative_translation_optimization": [
        "--1dsfm_dataset_directory", "x"],
    "compute_reconstruction_statistics": ["--reconstruction", "x.npz"],
    "undistort_images": ["--reconstruction", "x.npz",
                         "--input_images_directory", "x",
                         "--output_images_directory", "y"],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The model as npz, Theia .bin, NVM and bundler files, a SIFT key
    file (text and binary), and its views' true poses with noise as a
    second npz."""
    d = tmp_path_factory.mktemp("host")
    _, m = make_recons(0)
    tio.write_reconstruction(m, str(d / "model.npz"))
    tio.write_theia_reconstruction(str(d / "model.bin"), m)
    tio.write_nvm(m, str(d / "model.nvm"))
    tio.write_bundler(m, str(d / "list.txt"), str(d / "bundle.out"))
    kps, desc = _features(3)
    tio.write_sift_text(str(d / "view.key"), kps, desc)
    tio.write_sift_binary(str(d / "view.bin"), kps, desc)
    rng = np.random.default_rng(4)
    for v in m.views.values():
        v.camera.extrinsics[:3] = 1.7 * v.camera.extrinsics[:3] + \
            rng.normal(scale=0.01, size=3) + [3.0, -1.0, 0.5]
        v.camera.extrinsics[3:] += rng.normal(scale=0.01, size=3)
    tio.write_reconstruction(m, str(d / "noisy.npz"))
    return d


def _both(name, args_for, monkeypatch, tmp_path, **kw):
    """Run JAX's and the port's CLI, each writing under its own
    directory of tmp_path; the printouts compared with the directories
    named alike."""
    rc_j, out_j = run_jax(name, args_for(tmp_path / "jax"), monkeypatch)
    rc_p, out_p = run_port(name, args_for(tmp_path / "port"))
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, kw.get("rel", HOST_REL),
                         last_digit=kw.get("last_digit", False),
                         subs=[(str(tmp_path / "port"), "<out>"),
                               (str(tmp_path / "jax"), "<out>")])
    return out_p


def _mkdirs(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()


# -------------------------------------------------- converters

@pytest.mark.parametrize("source", ["bundler", "nvm"])
def test_converters_to_native_match_jax(source, files, tmp_path,
                                        monkeypatch):
    """convert_bundle_file and convert_nvm_file: the npz each package
    writes holds the same model (within 1e-12 where the reader computed
    a rotation)."""
    _mkdirs(tmp_path)
    if source == "bundler":
        name = "convert_bundle_file"

        def args(o):
            return ["--lists_file", files / "list.txt", "--bundle_file",
                    files / "bundle.out", "--output_reconstruction_file",
                    o / "out.npz"]
    else:
        name = "convert_nvm_file"

        def args(o):
            return ["--input_nvm_file", files / "model.nvm",
                    "--output_reconstruction_file", o / "out.npz"]
    out = _both(name, args, monkeypatch, tmp_path)
    a = tio.read_reconstruction(str(tmp_path / "port" / "out.npz"))
    b = jio.read_reconstruction(str(tmp_path / "jax" / "out.npz"))
    assert_recons_agree(a, b, REL)
    assert out == f"{a.num_views()} views, {a.num_tracks()} tracks\n"


@pytest.mark.parametrize("src,dst", [("view.key", "out.bin"),
                                     ("view.bin", "out.key")])
def test_convert_sift_key_file_matches_jax(src, dst, files, tmp_path,
                                           monkeypatch):
    _mkdirs(tmp_path)
    _both("convert_sift_key_file", lambda o: [
        "--input_sift_key_file", files / src, "--output_sift_key_file",
        o / dst], monkeypatch, tmp_path)
    assert (tmp_path / "port" / dst).read_bytes() == \
        (tmp_path / "jax" / dst).read_bytes()


EXPORTS = {
    "convert_theia_reconstruction_to_bundler_file": (
        lambda i, o: ["--input_reconstruction_file", i,
                      "--output_bundler_file", o / "bundle.out",
                      "--output_list_file", o / "list.txt"],
        ["bundle.out", "list.txt"]),
    "export_colmap_files": (
        lambda i, o: ["--input_reconstruction_file", i, "--output_folder",
                      o / "colmap"],
        ["colmap/cameras.txt", "colmap/images.txt", "colmap/points3D.txt"]),
    "export_to_nvm_file": (
        lambda i, o: ["--input_reconstruction_file", i, "--output_nvm_file",
                      o / "model.nvm"], ["model.nvm"]),
    "write_reconstruction_ply_file": (
        lambda i, o: ["--reconstruction", i, "--ply_file", o / "model.ply"],
        ["model.ply"]),
}


@pytest.mark.parametrize("source", ["model.npz", "model.bin"])
@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_exporters_match_jax(name, source, files, tmp_path, monkeypatch):
    """Each exporter from the npz and from the Theia .bin (the shared
    loader's two branches): the same files, numbers within 1e-12."""
    _mkdirs(tmp_path)
    args, outs = EXPORTS[name]
    _both(name, lambda o: args(files / source, o), monkeypatch, tmp_path)
    for f in outs:
        assert_text_agrees(tmp_path / "port" / f, tmp_path / "jax" / f, REL)


def test_create_reconstruction_from_strecha_dataset_matches_jax(
        tmp_path, monkeypatch):
    """A Strecha directory as tests/test_torch_io.py writes one."""
    rng = np.random.default_rng(5)
    d = tmp_path / "strecha"
    d.mkdir()
    for i in range(3):
        K = np.array([[2759.48 + i, 0.5, 1520.69], [0, 2764.16, 1006.81],
                      [0, 0, 1]])
        vals = [*K.ravel(), 0, 0, 0, *_rotation(rng).ravel(),
                *rng.normal(size=3), 3072, 2048]
        (d / f"{i:04d}.png.camera").write_text(
            "\n".join(" ".join(repr(float(v)) for v in vals[k:k + 3])
                      for k in range(0, 24, 3)) + "\n3072 2048\n")
    _mkdirs(tmp_path)
    out = _both("create_reconstruction_from_strecha_dataset", lambda o: [
        "--strecha_dataset_directory", d, "--output_reconstruction",
        o / "gt.npz"], monkeypatch, tmp_path)
    assert out.startswith("wrote 3 views (3 with ground-truth poses)")
    assert_recons_agree(
        tio.read_reconstruction(str(tmp_path / "port" / "gt.npz")),
        jio.read_reconstruction(str(tmp_path / "jax" / "gt.npz")), REL)


# -------------------------------------------------- evaluation

@pytest.mark.parametrize("reference", ["model.npz", "model.bin"])
def test_compare_reconstructions_matches_jax(reference, files, tmp_path,
                                             monkeypatch):
    """The noisy similar copy against the model, read from the npz and
    from the Theia .bin (load_any's two branches); the unused
    --robust_alignment_threshold is accepted as in JAX."""
    out = _both("compare_reconstructions", lambda o: [
        "--reference_reconstruction", files / reference,
        "--reconstruction_to_align", files / "noisy.npz",
        "--robust_alignment_threshold", "0.5"], monkeypatch, tmp_path)
    assert out.startswith("common cameras: 4\n")


def test_compare_reconstructions_needs_three_common_cameras(files, tmp_path):
    m = tio.read_reconstruction(str(files / "model.npz"))
    for v in list(m.views)[:3]:
        m.views[v].is_estimated = False
    tio.write_reconstruction(m, str(tmp_path / "two.npz"))
    assert run_port("compare_reconstructions", [
        "--reference_reconstruction", files / "model.npz",
        "--reconstruction_to_align", tmp_path / "two.npz"]) == \
        (1, "insufficient common cameras\n")


def test_compute_reconstruction_statistics_matches_jax(files, tmp_path,
                                                       monkeypatch):
    rc_j, out_j = run_jax("compute_reconstruction_statistics", [
        "--reconstruction", files / "model.npz"], monkeypatch)
    rc_p, out_p = run_port("compute_reconstruction_statistics", [
        "--reconstruction", files / "model.npz", "--device", "cpu"])
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, DEVICE_REL, last_digit=True)
    assert "observations: " in out_p


def test_compute_matching_relative_pose_errors_matches_jax(files,
                                                           tmp_path,
                                                           monkeypatch):
    """A database of five matches between the model's views (one with a
    view the ground truth lacks), their two-view infos the noisy
    model's relative poses."""
    truth = tio.read_reconstruction(str(files / "model.npz"))
    noisy = tio.read_reconstruction(str(files / "noisy.npz"))
    db = DiskFeaturesAndMatchesDatabase(str(tmp_path / "db"))
    names = {v: truth.views[v].name for v in truth.views}
    from theiasfm_tpu_torch.io._rotation import (
        angle_axis_to_rotation_matrix, rotation_matrix_to_angle_axis)
    for v1, v2 in [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4)]:
        c1, c2 = noisy.views[v1].camera, noisy.views[v2].camera
        R1 = angle_axis_to_rotation_matrix(c1.extrinsics[3:])
        R2 = angle_axis_to_rotation_matrix(c2.extrinsics[3:])
        d = R1 @ (c2.extrinsics[:3] - c1.extrinsics[:3])
        info = TwoViewInfo(rotation_2=rotation_matrix_to_angle_axis(
            R2 @ R1.T), position_2=d / np.linalg.norm(d),
            num_verified_matches=50)
        db.put_match(names[v1], names[v2], ImagePairMatch(
            names[v1], names[v2], info))
    for v in truth.views:   # im4 has no ground truth
        truth.views[v].is_estimated = v != 4
    tio.write_reconstruction(truth, str(tmp_path / "gt.npz"))
    out = _both("compute_matching_relative_pose_errors", lambda o: [
        "--matches_dir", tmp_path / "db", "--reconstruction",
        tmp_path / "gt.npz"], monkeypatch, tmp_path)
    assert out.startswith("matched pairs with ground truth: 4\n")


def test_view_reconstruction_matches_jax(files, tmp_path, monkeypatch):
    """The same PNG, pixel for pixel (the same matplotlib calls on the
    same points), also when --max_points subsamples."""
    from PIL import Image
    _mkdirs(tmp_path)
    _both("view_reconstruction", lambda o: [
        "--reconstruction", files / "model.npz", "--output",
        o / "view.png", "--max_points", "20"], monkeypatch, tmp_path)
    a = np.asarray(Image.open(tmp_path / "port" / "view.png"))
    b = np.asarray(Image.open(tmp_path / "jax" / "view.png"))
    assert a.shape == b.shape and (a == b).all()


# -------------------------------------------------- entry points

def test_every_new_cli_runs_as_a_module(tmp_path):
    """One interpreter runs `--help` of every new module through runpy
    (as `python -m` does): each prints its usage and exits 0, and
    nothing imports jax or the JAX package."""
    code = f"""
import runpy, sys
for name in {NEW_CLIS!r}:
    sys.argv = [name, "--help"]
    try:
        runpy.run_module("theiasfm_tpu_torch.apps." + name,
                         run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
    else:
        raise AssertionError(name + " did not exit")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "theiasfm_tpu"))
assert not bad, bad
print("ran", len({NEW_CLIS!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("usage: ") == len(NEW_CLIS) == 22
    assert out.stdout.rstrip().endswith("ran 22")


def test_the_port_has_every_cli_of_the_jax_package():
    assert sorted(p.stem for p in (REPO / "theiasfm_tpu_torch" / "apps")
                  .glob("*.py") if p.stem != "__init__") == sorted(
        p.stem for p in (REPO / "apps").glob("*.py"))


@pytest.mark.parametrize("name", sorted(DEVICE_CLIS))
def test_device_cli_fails_at_once_without_a_card(name):
    """The default --device cuda without a card raises resolve_device's
    error before anything is read (the inputs do not exist): a run as
    `python -m` exits non-zero with that message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        port_cli(name).main(DEVICE_CLIS[name])


def test_host_clis_take_no_device_flag():
    for name in set(NEW_CLIS) - set(DEVICE_CLIS):
        with pytest.raises(SystemExit):
            port_cli(name).main(["--device", "cpu"])
