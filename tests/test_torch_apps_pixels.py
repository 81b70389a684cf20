"""The port's CLIs that start from pixels (theiasfm_tpu_torch/apps:
extract_features, calibrate_camera_intrinsics, undistort_images,
colorize_reconstruction, export_reconstruction_to_pmvs,
create_calibration_file_from_exif) against the JAX package's CLIs
(apps/) on the same files, on the CPU, and the one image decoder they
share (image.FloatImage.from_file) against the JAX CLIs' inline PIL
reads. compute_two_view_geometry is held in
tests/test_torch_apps_two_view.py.

Tolerances: the text between numbers is equal; numbers within 1e-9
relative where both packages compute on the host in float64. SIFT's
keypoints agree as in tests/test_torch_sift.py (98% within 1e-3 px both
ways, their descriptors within 1e-3); extract_features runs at
--feature_density SPARSE (512 keypoints per octave), as the port's CPU
SIFT costs in proportion to its keypoint slots. The calibration
CLI is held to JAX's through a stub builder (the options of each round,
the prior carried from round to round, the printout and the file); its
real CPU run is part of chip_smoke.apps_f2's rehearsal
(tests/test_torch_apps_rehearsal.py)."""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import theiasfm_tpu.io as jio
import theiasfm_tpu_torch.io as tio
from theiasfm_tpu.image import load_gray as jload_gray
from theiasfm_tpu.matching import DiskFeaturesAndMatchesDatabase as JDisk
from theiasfm_tpu_torch.image import FloatImage, load_gray
from theiasfm_tpu_torch.matching import DiskFeaturesAndMatchesDatabase
from chip_smoke import write_png
from test_torch_io import assert_recons_agree, assert_text_agrees, make_recons
from torch_apps_cases import (HOST_REL, assert_same_printout, port_cli,
                              render_views, run_jax, run_port)
from torch_sfm_cases import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """The first two of three 320 x 240 renderings (focal 300) as 8-bit
    PNGs."""
    d = tmp_path_factory.mktemp("views")
    ims, cams = render_views(3, (320, 240), 300.0)
    for i, im in enumerate(ims[:2]):
        write_png(d / f"v{i}.png", im)
    return d, cams


# ----------------------------------------------------------- decoding

def _image(mode, rng, dark=False):
    from PIL import Image
    hi = 2 if dark else 256
    if mode == "L":
        return Image.fromarray(rng.integers(0, hi, (15, 20), np.uint8))
    if mode == "P":
        return Image.fromarray(rng.integers(0, hi, (15, 20, 3), np.uint8)
                               ).convert("P")
    ch = {"RGB": 3, "RGBA": 4}[mode]
    return Image.fromarray(rng.integers(0, hi, (15, 20, ch), np.uint8),
                           mode)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P", "dark_RGB"])
def test_float_image_reads_as_the_jax_clis_do(mode, tmp_path):
    """FloatImage.from_file gives undistort_images' read
    (np.asarray(Image.open(p), float32) / 255) and, with mode="RGB",
    colorize_reconstruction's (.convert("RGB") first), bit for bit, for
    gray, colour, alpha, palette and all-dark 8-bit PNGs; load_gray
    equals the JAX package's on every image with a pixel above 1."""
    from PIL import Image
    rng = np.random.default_rng(0)
    dark = mode.startswith("dark_")
    path = tmp_path / "im.png"
    _image(mode.removeprefix("dark_"), rng, dark).save(path)
    undistort_read = np.asarray(Image.open(path), np.float32) / 255.0
    colorize_read = np.asarray(Image.open(path).convert("RGB"),
                               np.float32) / 255.0
    got = FloatImage.from_file(str(path)).pixels
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, undistort_read)
    np.testing.assert_array_equal(
        FloatImage.from_file(str(path), mode="RGB").pixels, colorize_read)
    if not dark and mode != "P":
        np.testing.assert_array_equal(load_gray(str(path)),
                                      jload_gray(str(path)))


# -------------------------------------------------------- from pixels

def test_extract_features_matches_jax(views, tmp_path, monkeypatch):
    d, _ = views
    glob_ = str(d / "*.png")
    sparse = ["--feature_density", "SPARSE"]
    rc_j, out_j = run_jax("extract_features", [
        "--input_images", glob_, "--features_output_directory",
        tmp_path / "jax"] + sparse, monkeypatch)
    rc_p, out_p = run_port("extract_features", [
        "--input_images", glob_, "--features_output_directory",
        tmp_path / "port", "--device", "cpu"] + sparse)
    assert rc_j == rc_p == 0
    assert out_p == out_j == "extracted features for 2 new images " \
                             "(2 total)\n"
    # a second run finds every image in its database
    assert run_port("extract_features", [
        "--input_images", glob_, "--features_output_directory",
        tmp_path / "port", "--device", "cpu"] + sparse)[1].startswith(
        "extracted features for 0 new images")
    a = DiskFeaturesAndMatchesDatabase(str(tmp_path / "port"))
    b = JDisk(str(tmp_path / "jax"))
    assert a.image_names_of_features() == b.image_names_of_features()
    for n in a.image_names_of_features():
        fa, fb = a.get_features(n), b.get_features(n)
        assert len(fa.keypoints) == len(fb.keypoints) > 400
        # tests/test_torch_sift.py's rule: positions within 1e-3 px both
        # ways and descriptors within 1e-3 for 98% of the keypoints (a
        # float32 near-tie can flip a keypoint's dominant orientation)
        dist = np.linalg.norm(fa.keypoints[:, None, :2] -
                              fb.keypoints[None, :, :2], axis=-1)
        assert np.mean(dist.min(1) <= 1e-3) >= 0.98
        assert np.mean(dist.min(0) <= 1e-3) >= 0.98
        nn, close = dist.argmin(1), dist.min(1) <= 1e-3
        linf = np.abs(fa.descriptors[close] - fb.descriptors[nn[close]])
        assert np.mean(linf.max(1) <= 1e-3) >= 0.98


def _stub_builder(seen, model):
    """A ReconstructionBuilder that records its options and what
    add_image gets, and returns `model` (SimpleNamespace) each round,
    its focal length moved per round."""
    class Stub:
        def __init__(self, options, db=None, **kw):
            seen.append(dict(options=options, images=[]))

        def add_image(self, path, prior=None, group=None):
            seen[-1]["images"].append(
                (path, None if prior is None else
                 dataclasses.asdict(prior), group))

        def extract_and_match_features(self):
            return 0

        def build_reconstruction(self):
            model.views[1].camera.intrinsics[0] = 180.0 + 7.25 * len(seen)
            return [model]
    return Stub


def _flat(o):
    return {f.name: (_flat(getattr(o, f.name))
                     if dataclasses.is_dataclass(getattr(o, f.name))
                     else getattr(o, f.name))
            for f in dataclasses.fields(o)}


@pytest.mark.parametrize("estimator", ["INCREMENTAL", "GLOBAL"])
def test_calibrate_camera_intrinsics_matches_jax(estimator, views,
                                                 tmp_path, monkeypatch):
    """Three rounds through a stub builder in both packages: the same
    options each round (all 10 intrinsics of the shared group), every
    image in group 0 with no prior, then the last round's focal length
    as the prior; the same printout and calibration file."""
    from theiasfm_tpu.sfm import reconstruction_builder as jrb
    d, _ = views
    intr = np.array([180.0, 1.0, 0.0, 100.0, 75.0, 0.01, -0.002, 0, 0, 0])

    def model():
        cam = types.SimpleNamespace(intrinsics=intr.copy())
        return types.SimpleNamespace(
            views={1: types.SimpleNamespace(camera=cam)},
            estimated_views=lambda: [1])
    images = sorted(str(p) for p in d.glob("*.png"))
    (tmp_path / "imgs").mkdir()
    for i in range(3):
        (tmp_path / "imgs" / f"c{i}.png").write_bytes(
            open(images[i % 2], "rb").read())
    argv = ["--images", tmp_path / "imgs" / "*.png",
            "--num_calibration_iterations", "3",
            "--reconstruction_estimator", estimator]
    seen_j, seen_p = [], []
    monkeypatch.setattr(jrb, "ReconstructionBuilder",
                        _stub_builder(seen_j, model()))
    rc_j, out_j = run_jax("calibrate_camera_intrinsics", argv + [
        "--output_calibration_file", tmp_path / "jax.json"], monkeypatch)
    mod = port_cli("calibrate_camera_intrinsics")
    monkeypatch.setattr(mod, "ReconstructionBuilder",
                        _stub_builder(seen_p, model()))
    rc_p, out_p = run_port("calibrate_camera_intrinsics", argv + [
        "--output_calibration_file", tmp_path / "port.json",
        "--device", "cpu"])
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, HOST_REL,
                         subs=[(str(tmp_path / "port.json"), "<out>"),
                               (str(tmp_path / "jax.json"), "<out>")])
    assert len(seen_p) == len(seen_j) == 3
    for p, j in zip(seen_p, seen_j):
        assert _flat(p["options"]) == _flat(j["options"])
        assert p["images"] == j["images"]
    assert p["options"].reconstruction_estimator_type == estimator
    assert p["options"].incremental_options.intrinsics_optimized == \
        (True,) * 10
    assert seen_p[0]["images"][0][1] is None
    assert seen_p[2]["images"][0][1]["focal_length"] == 180.0 + 7.25 * 2
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    a = tio.read_calibration(str(tmp_path / "port.json"))
    assert sorted(a) == ["c0.png", "c1.png", "c2.png"]
    assert a["c0.png"].focal_length == 180.0 + 7.25 * 3


def test_calibrate_needs_three_images(tmp_path):
    assert run_port("calibrate_camera_intrinsics", [
        "--images", tmp_path / "*.png", "--device", "cpu"])[0] == 1


# ----------------------------------------------------- image tools

@pytest.fixture(scope="module")
def model_and_images(tmp_path_factory):
    """make_recons' 5-view model (im3 radial-tangential, im4 not
    estimated; radial distortion on every camera) as an npz, and PNG
    files under the views' names (.png): im0 gray, im1 and im4 RGB, im3 RGBA,
    480 x 640 (the model's size); im2 missing."""
    d = tmp_path_factory.mktemp("tools")
    _, port = make_recons(0)
    for vid, v in port.views.items():
        v.camera.intrinsics[5:7] = [-0.05, 0.01]
        # undistort_images writes each image under its view's name: PNG
        # keeps the pixels the comparison reads
        del port._name_to_id[v.name]
        v.name = v.name.replace(".jpg", ".png")
        port._name_to_id[v.name] = vid
    tio.write_reconstruction(port, str(d / "model.npz"))
    (d / "images").mkdir()
    rng = np.random.default_rng(1)
    for i, ch in ((0, 0), (1, 3), (3, 4), (4, 3)):
        shape = (480, 640) + ((ch,) if ch else ())
        write_png(d / "images" / f"im{i}.png", rng.random(shape))
    return d


def test_undistort_images_matches_jax(model_and_images, tmp_path,
                                      monkeypatch):
    """The same images written, pixel by pixel within one 8-bit step
    (the resampling truncated to uint8), 99.99% equal. The port
    resamples in float64 here, as JAX's undistort_image does under the
    suite's x64 mode."""
    from PIL import Image
    d = model_and_images
    mod = port_cli("undistort_images")
    monkeypatch.setattr(mod, "undistort_image", functools.partial(
        mod.undistort_image, dtype=torch.float64))
    base = ["--reconstruction", d / "model.npz",
            "--input_images_directory", d / "images"]
    rc_j, out_j = run_jax("undistort_images", base + [
        "--output_images_directory", tmp_path / "jax"], monkeypatch)
    rc_p, out_p = run_port("undistort_images", base + [
        "--output_images_directory", tmp_path / "port", "--device", "cpu"])
    assert rc_j == rc_p == 0 and out_p == out_j == "undistorted 4 images\n"
    for p in sorted((tmp_path / "jax").iterdir()):
        a = np.asarray(Image.open(tmp_path / "port" / p.name), np.int32)
        b = np.asarray(Image.open(p), np.int32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= 0.9999


def test_colorize_reconstruction_matches_jax(model_and_images, tmp_path,
                                             monkeypatch):
    d = model_and_images
    base = ["--input_reconstruction", d / "model.npz",
            "--image_directory", d / "images"]
    rc_j, out_j = run_jax("colorize_reconstruction", base + [
        "--output_reconstruction", tmp_path / "jax.npz"], monkeypatch)
    rc_p, out_p = run_port("colorize_reconstruction", base + [
        "--output_reconstruction", tmp_path / "port.npz"])
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, HOST_REL, subs=[
        (str(tmp_path / "port.npz"), "<out>"),
        (str(tmp_path / "jax.npz"), "<out>")])
    a = tio.read_reconstruction(str(tmp_path / "port.npz"))
    assert_recons_agree(a, jio.read_reconstruction(str(tmp_path /
                                                       "jax.npz")))
    before = tio.read_reconstruction(str(d / "model.npz"))
    assert sum((a.tracks[t].color != before.tracks[t].color).any()
               for t in a.tracks) > 20


def test_export_reconstruction_to_pmvs_matches_jax(model_and_images,
                                                   tmp_path, monkeypatch):
    d = model_and_images
    base = ["--reconstruction", d / "model.npz", "--images_directory",
            d / "images"]
    rc_j, out_j = run_jax("export_reconstruction_to_pmvs", base + [
        "--pmvs_working_directory", tmp_path / "jax"], monkeypatch)
    rc_p, out_p = run_port("export_reconstruction_to_pmvs", base + [
        "--pmvs_working_directory", tmp_path / "port"])
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, HOST_REL, subs=[
        (str(tmp_path / "port"), "<out>"), (str(tmp_path / "jax"),
                                            "<out>")])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in
                           (tmp_path / "port").rglob("*") if p.is_file())
    assert len([f for f in files if f.parts[0] == "txt"]) == 4
    for f in files:
        if f.suffix == ".txt":
            assert_text_agrees(tmp_path / "port" / f, tmp_path / "jax" / f,
                               1e-12)
        else:
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes()


def test_create_calibration_file_from_exif_matches_jax(tmp_path,
                                                       monkeypatch):
    """Two EXIF JPEGs (a camera in the sensor database, one not) and a
    file with no EXIF: the same printout (stdout) and calibration file."""
    from test_torch_exif_utils import _exif_jpeg
    from PIL import Image
    (tmp_path / "im").mkdir()
    _exif_jpeg(tmp_path / "im" / "a.jpg")
    _exif_jpeg(tmp_path / "im" / "b.jpg", make="Acme", model="Acme X1",
               focal_mm=5.0, plane=2540.0)
    Image.new("RGB", (64, 48)).save(tmp_path / "im" / "c.jpg")
    base = ["--images", tmp_path / "im" / "*.jpg"]
    rc_j, out_j = run_jax("create_calibration_file_from_exif", base + [
        "--output_calibration_file", tmp_path / "jax.json"], monkeypatch)
    rc_p, out_p = run_port("create_calibration_file_from_exif", base + [
        "--output_calibration_file", tmp_path / "port.json"])
    assert rc_j == rc_p == 0
    assert out_p == out_j and "a.jpg: focal=" in out_p
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
