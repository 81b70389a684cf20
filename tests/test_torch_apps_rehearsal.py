"""The CPU rehearsal of chip_smoke.py's `apps_f2` phase (the port's other
22 CLIs in process), after `io_cli`'s, whose model and database it
works on, as tests/test_torch_apps.py rehearses `io_cli`.

Three 320 x 240 renderings (focal 300) stand for the card's 24 views
and 8 views: the phase writes them as PNGs and every CLI runs with
--device cpu. To keep the run short, SIFT runs once per image with 256
keypoints per octave (a cache in front of extract_sift and
extract_sift_batch, keyed by the pixels and the options), the city has
30 views and its global BA is stubbed out (as in
tests/test_torch_apps_1dsfm.py), calibrate runs once with one round
(a round costs some 7 s on the CPU here; the card runs three to six of
two),
INCREMENTAL reconstructs (GLOBAL in float32 builds no model on so few
views, ROADMAP queue 3), every
test module's torch runs on one thread (tests/torch_sfm_cases.py), and
the gates are loose where three small views cannot meet the card's (the
pose limits, the calibration and the city gate); the checks that hold
on any input stay: the top2_match count (the CPU's brute force counted
as the card's two launches per chunk), the features against
extract_sift_batch, the putative matches against the CPU's, the card
against the CPU (here the CPU against itself), the histogram bins
against the scene, and every file read back."""
import dataclasses
import hashlib
import time

import numpy as np

import chip_smoke as cs
from theiasfm_tpu_torch.image import SiftOptions, extract_sift
from theiasfm_tpu_torch.matching import feature_matcher as tfmod
from theiasfm_tpu_torch.sfm import feature_extractor as tfe
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb
from theiasfm_tpu_torch.sfm.pipeline import global_pipeline as tgp
from theiasfm_tpu_torch.utils import count_dispatch
from torch_apps_cases import port_cli, render_views
from torch_sfm_cases import one_torch_thread  # noqa: F401


def _sift_cache(monkeypatch):
    """extract_sift / extract_sift_batch computed once per (pixels,
    options) on the CPU, wherever the phase's CLIs call them, with a
    budget of 256 keypoints per octave (CPU SIFT's cost follows its
    padded keypoint slots)."""
    memo = {}

    def one(img, opts=SiftOptions(), device="cpu"):
        img = np.asarray(img, np.float32)
        key = (hashlib.sha1(img.tobytes()).hexdigest(), img.shape,
               repr(opts))
        if key not in memo:
            memo[key] = extract_sift(img, dataclasses.replace(
                opts, max_features_per_octave=256), device="cpu")
        return memo[key]

    def batch(images, opts=SiftOptions(), device="cpu"):
        return [one(im, opts) for im in images]
    for mod in (cs, tfe, trb):
        if hasattr(mod, "extract_sift_batch"):
            monkeypatch.setattr(mod, "extract_sift_batch", batch)
    monkeypatch.setattr(port_cli("compute_two_view_geometry"),
                        "extract_sift", one)
    return one


def test_apps_f2_rehearsal_on_cpu(monkeypatch):
    one = _sift_cache(monkeypatch)
    views, cams = render_views(3, (320, 240), 300.0)
    names = [f"view{i:03d}" for i in range(3)]
    # the features io_cli's database gets: the PNG's pixels, as the
    # phase's extract_features sees them
    from PIL import Image
    arrays = {}
    for n, v in zip(names, views):
        q = np.asarray(Image.fromarray(np.round(v * 255).astype(np.uint8)),
                       np.float32) / 255.0
        k, d, ok = one(q)
        arrays[n] = (k[ok], d[ok])
    scene = dict(names=names, cams=cams, views=views, arrays=arrays,
                 priors={n: dict(image_width=320, image_height=240,
                                 focal_length=300.0,
                                 principal_point=(160.0, 120.0))
                         for n in names})

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
    lines = []
    monkeypatch.setattr(cs, "emit", lambda phase, **f: lines.append(
        (phase, f)))
    monkeypatch.setattr(cs, "IO_CLI_FLAGS", cs.IO_CLI_FLAGS + (
        "--reconstruction_estimator", "INCREMENTAL"))
    monkeypatch.setattr(cs, "GLOBAL24_OPTIONS", dataclasses.replace(
        cs.GLOBAL24_OPTIONS, reconstruction_estimator_type="INCREMENTAL"))
    monkeypatch.setattr(cs, "F2_TWO_VIEW_DEG", (180.0, 180.0))
    monkeypatch.setattr(cs, "F2_PAIR_ROT_DEG", 180.0)
    monkeypatch.setattr(cs, "F2_CALIB_GATE", dict(
        views_min=3, focal_min=0.0, focal_max=np.inf))
    monkeypatch.setattr(cs, "F2_CALIB_ROUNDS", 1)
    monkeypatch.setattr(cs, "F2_CALIB_HITS", 1)
    monkeypatch.setattr(cs, "F2_CALIB_RUNS", 1)
    monkeypatch.setattr(cs, "F2_CITY", (30, 4000))
    monkeypatch.setattr(cs, "F2_CITY_GATE", (0.8, 100.0))
    monkeypatch.setattr(tgp, "_run_ba", lambda *a, **k: None)

    keep = {}
    cs.phase_io_cli(scene, device="cpu", gate=(1.0, 5.0), keep=keep)
    assert (keep["dir"] / "out" / "model-0.npz").exists()
    n_top2 = cs.phase_apps_f2(scene, scene, keep["dir"], device="cpu")
    assert not keep["dir"].exists()
    phase, res = lines[-1]
    assert phase == "apps_f2" and res["clis"] == 22 and not res["host_only"]
    assert sorted(res["wall_s"]) == sorted(cs.APPS_F2)
    cal = res["readings"]["calibrate_camera_intrinsics"]
    assert n_top2 == cal["top2_match"] == 2 * cal["chunks"] > 0
    assert [[i["views"] for i in its] for its in cal["runs"]] == [[3]]
    tv = res["readings"]["compute_two_view_geometry"]
    assert tv["putative_equal_cpu"]
    assert tv["rotation_vs_cpu_deg"] == tv["position_vs_cpu_deg"] == 0.0
    assert res["readings"]["extract_features"][
        "keypoints_within_0_01px"] == 1.0
    assert max(res["readings"]["converters"][
        "rotation_derived_max_rel"].values()) <= 1e-9
