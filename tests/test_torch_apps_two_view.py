"""The port's compute_two_view_geometry CLI (theiasfm_tpu_torch/apps)
against the JAX package's (apps/) on the same two PNGs, on the CPU, and
the port's own RANSAC draw.

Both CLIs decode the PNGs (their shapes give the principal points) and
get the same features in place of SIFT: 600 points of a random scene
seen by both cameras of two renderings, projected with 0.3 px of noise,
a fifth of them moved in the second view (outliers), their descriptors
unit vectors with noise, and 200 unmatched features padding each view.
SIFT itself is held to JAX's in tests/test_torch_apps_pixels.py
(extract_features) and tests/test_torch_sift.py; this file holds what
the CLI does from the features on (the brute-force matcher, the RANSAC
draw, the focal lengths and principal points, the estimate and the
printout). The comparison hands the port JAX's draw
(jax.random.PRNGKey(0)), as every port-against-JAX verification test
does. Tolerance: the text between numbers equal, the numbers within
1e-4 plus one unit in the last printed place."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import theiasfm_tpu.image as jimage
from chip_smoke import _pose_gap, _true_relative, write_png
from theiasfm_tpu_torch.image import load_gray
from theiasfm_tpu_torch.utils import next_bucket
from torch_apps_cases import (DEVICE_REL, assert_same_printout, port_cli,
                              render_views, run_jax, run_port)
from torch_sfm_cases import one_torch_thread  # noqa: F401

SIZE, FOCAL = (320, 240), 300.0


def _features(cams, rng, n=600, outliers=0.2, extra=200, slots=1024):
    """(keypoints (slots, 4), descriptors (slots, 128), valid) of both
    views, as extract_sift returns them."""
    (w, h), (c0, c1) = SIZE, cams
    pix = rng.uniform([8, 8], [w - 8, h - 8], (4 * n, 2))
    depth = rng.uniform(4.0, 12.0, 4 * n)
    ray = np.c_[(pix - [w / 2, h / 2]) / FOCAL, np.ones(4 * n)]
    X = (ray * depth[:, None] - c0["t"]) @ c0["R"]
    x1 = X @ c1["R"].T + c1["t"]
    p1 = x1[:, :2] / x1[:, 2:] * FOCAL + [w / 2, h / 2]
    keep = np.nonzero((x1[:, 2] > 0.5) & (p1 > 8).all(1) &
                      (p1 < [w - 8, h - 8]).all(1))[0][:n]
    assert len(keep) == n
    p0, p1 = pix[keep], p1[keep]
    bad = rng.random(n) < outliers
    p1[bad] = rng.uniform([8, 8], [w - 8, h - 8], (bad.sum(), 2))
    desc = rng.normal(size=(n, 128))
    out = []
    for p in (p0, p1):
        d = np.r_[desc + 0.05 * rng.normal(size=desc.shape),
                  rng.normal(size=(extra, 128))]
        kp = np.zeros((slots, 4), np.float32)
        kp[:n + extra, :2] = np.r_[p + 0.3 * rng.normal(size=p.shape),
                                   rng.uniform([0, 0], [w, h], (extra, 2))]
        kp[:n + extra, 2] = 1.6
        ds = np.zeros((slots, 128), np.float32)
        ds[:n + extra] = d / np.linalg.norm(d, axis=1, keepdims=True)
        out.append((kp, ds, np.arange(slots) < n + extra))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Views 0 and 1 of three renderings as PNGs, their cameras, and the
    features each CLI's SIFT call returns for each (keyed by the decoded
    pixels)."""
    d = tmp_path_factory.mktemp("pair")
    ims, cams = render_views(3, SIZE, FOCAL)
    feats = {}
    for i, f in enumerate(_features(cams[:2], np.random.default_rng(0))):
        write_png(d / f"v{i}.png", ims[i])
        feats[load_gray(str(d / f"v{i}.png")).tobytes()] = f
    return d, cams, feats


def _sift_stub(feats, calls):
    def extract_sift(image, opts=None, device=None):
        calls.append(opts)
        return feats[np.asarray(image, np.float32).tobytes()]
    return extract_sift


def _jax_draw(num_matches, num_hypotheses, device):
    """The samples JAX's CLI draws: jax.random.PRNGKey(0) through its
    random_samples over the matches padded to the bucket."""
    from theiasfm_tpu.solvers.ransac import random_samples
    n = next_bucket(num_matches, 64)
    idx = random_samples(jax.random.PRNGKey(0), n, 5, num_hypotheses,
                         jnp.arange(n) < num_matches)
    return torch.as_tensor(np.array(idx), dtype=torch.int64,
                           device=device)


def test_compute_two_view_geometry_matches_jax(pair, monkeypatch):
    """With the same features and JAX's samples the port prints JAX's
    feature, putative and verified counts and its pose within 1e-4; the
    pose is the scene's within 1 degree. Under the suite's x64 mode JAX's
    CLI estimates the pose in float64 (its principal point, a float64
    array, promotes the float32 keypoints), so the port's
    estimate_twoview_info runs in float64 here too."""
    from theiasfm_tpu_torch.image import SiftOptions
    d, cams, feats = pair
    argv = ["--image1", d / "v0.png", "--image2", d / "v1.png",
            "--focal1", FOCAL, "--focal2", FOCAL]
    jcalls, pcalls = [], []
    monkeypatch.setattr(jimage, "extract_sift", _sift_stub(feats, jcalls))
    rc_j, out_j = run_jax("compute_two_view_geometry", argv, monkeypatch)
    mod = port_cli("compute_two_view_geometry")
    monkeypatch.setattr(mod, "extract_sift", _sift_stub(feats, pcalls))
    monkeypatch.setattr(mod, "ransac_samples", _jax_draw)
    monkeypatch.setattr(mod, "estimate_twoview_info", functools.partial(
        mod.estimate_twoview_info, dtype=torch.float64))
    rc_p, out_p = run_port("compute_two_view_geometry",
                           argv + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    assert len(jcalls) == 2 and pcalls == [SiftOptions()] * 2
    assert_same_printout(out_p, out_j, DEVICE_REL, last_digit=True)
    assert out_p.startswith("features: 800 / 800\n")
    assert int(out_p.split("verified matches: ")[1].split()[0]) >= 400
    aa, c = _true_relative(cams[0], cams[1])
    truth = (f"relative rotation (angle-axis): {aa}\n"
             f"relative position (unit): {c}\n")
    assert max(_pose_gap(out_p, truth)) <= 1.0


def test_two_view_samples_are_drawn_on_the_cpu():
    """The port's own draw: a CPU generator seeded 0, the same indices
    whatever device they are moved to, each within the valid matches."""
    mod = port_cli("compute_two_view_geometry")
    a = mod.ransac_samples(70, 256, "cpu")
    b = mod.ransac_samples(70, 256, torch.device("cpu"))
    assert a.shape == (256, 5) and torch.equal(a, b)
    assert int(a.max()) < 70
    assert all(len(set(r.tolist())) == 5 for r in a)
