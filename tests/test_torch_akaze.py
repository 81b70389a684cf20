"""The port's AKAZE (theiasfm_tpu_torch/image/akaze.py) and SIFT's
_keypoint_orientation_maps against the JAX package's, on the CPU: stage
by stage on identical inputs, then end to end.

Tolerances (measured on three seeds of 48 x 56 smooth images):
* _fed_tau_schedule: the same host arithmetic, equal arrays.
* Each stage in float64 (JAX under x64): 1e-10 (measured at most 9e-16).
* Each stage in float32, FLOAT32 below: the Scharr gradients 5e-7
  (measured 7.5e-8), one FED cycle 5e-7 (6e-8), det(Hessian) 5e-6
  relative to its largest value (7.7e-7), the orientation 5e-6 rad
  (7.2e-7), the M-SURF descriptor 1e-6 (1.6e-7): the same float32
  code, the convolution and the sums ordered differently.
* extract_akaze end to end in float32 (JAX's own entry point casts to
  float32): the same set of valid keypoints (measured: equal on these
  images), their coordinates to 1e-5 and orientations to 1e-4 rad
  (measured 3e-6), the descriptors of the matched keypoints to 1e-4
  (measured 2e-6). A keypoint within rounding of the threshold could
  flip; none does here, so the sets must be equal.
* JAX's test_akaze_detects and test_akaze_translation_matching run
  through the port with their own bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from test_sift import make_test_image
from theiasfm_tpu.image import akaze as ja
from theiasfm_tpu.image import sift as js
from theiasfm_tpu_torch.image import akaze as ta
from theiasfm_tpu_torch.image import create_descriptor_extractor
from theiasfm_tpu_torch.image import sift as ts
from theiasfm_tpu_torch.matching import match_descriptors

from torch_sfm_cases import one_torch_thread  # noqa: F401

FLOAT32 = dict(scharr=5e-7, diffuse=5e-7, hessian=5e-6, orientation=5e-6,
               msurf=1e-6)
FLOAT64 = 1e-10
OPTS = dict(num_octaves=3, max_features_per_octave=256)


def _img(seed, h=48, w=56):
    g = np.random.default_rng(seed)
    x = ndimage.gaussian_filter(g.normal(size=(h, w)), 2.0)
    return (x - x.min()) / (x.max() - x.min())


def _tol(dtype, stage):
    return FLOAT64 if dtype == np.float64 else FLOAT32[stage]


def test_fed_tau_schedule_equal():
    for T in (0.3, 0.78, 1.0, 4.7, 12.0, 1e-6):
        for tau_max in (0.25, 0.1):
            np.testing.assert_array_equal(ta._fed_tau_schedule(T, tau_max),
                                          ja._fed_tau_schedule(T, tau_max))


DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]


@pytest.mark.parametrize("dt,tdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_diffusion_stages_match_jax(dt, tdt, seed):
    L0 = _img(seed).astype(dt)
    for a, b in zip(ja._gradients_scharr(jnp.asarray(L0)),
                    ta._gradients_scharr(torch.from_numpy(L0))):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= _tol(dt, "scharr")
    taus = ja._fed_tau_schedule(2.3, 0.25)
    jd = ja._diffuse_level(jnp.asarray(L0), jnp.asarray(0.05, dt),
                           jnp.asarray(taus, dt))
    td = ta._diffuse_level(torch.from_numpy(L0), torch.tensor(0.05, dtype=tdt),
                           torch.as_tensor(taus, dtype=tdt))
    assert td.dtype == tdt
    assert np.abs(np.asarray(jd) - td.numpy()).max() <= _tol(dt, "diffuse")
    jh = np.asarray(ja._hessian_response(jnp.asarray(L0), 2.26))
    th = ta._hessian_response(torch.from_numpy(L0), 2.26).numpy()
    assert np.abs(jh - th).max() <= _tol(dt, "hessian") * np.abs(jh).max()


@pytest.mark.parametrize("dt,tdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_orientation_and_msurf_match_jax(dt, tdt, seed):
    g = np.random.default_rng(seed + 10)
    S, H, W, K = 4, 48, 56, 20
    Ls = np.stack([_img(seed + s) for s in range(S)]).astype(dt)
    sl = g.integers(0, S, K)
    iy, ix = g.integers(10, H - 10, K), g.integers(10, W - 10, K)
    sig = (1.6 * 2.0 ** (sl / S)).astype(dt)
    gx = 0.5 * (np.roll(Ls, -1, 2) - np.roll(Ls, 1, 2))
    gy = 0.5 * (np.roll(Ls, -1, 1) - np.roll(Ls, 1, 1))
    mag = np.sqrt(gx ** 2 + gy ** 2).astype(dt)
    ang = np.arctan2(gy, gx).astype(dt)
    jth = np.asarray(js._keypoint_orientation_maps(
        *(jnp.asarray(a) for a in (mag, ang, sl, iy, ix, sig))))
    tth = ts._keypoint_orientation_maps(
        *(torch.from_numpy(a) for a in (mag, ang, sl, iy, ix, sig))).numpy()
    assert np.abs(jth - tth).max() <= _tol(dt, "orientation")
    theta = tth.astype(dt)
    jd = np.asarray(ja._msurf_descriptors(
        jnp.asarray(Ls), jnp.asarray(sl), jnp.asarray(iy.astype(dt)),
        jnp.asarray(ix.astype(dt)), jnp.asarray(sig), jnp.asarray(theta), S))
    td = ta._msurf_descriptors(
        torch.from_numpy(Ls), torch.from_numpy(sl),
        torch.from_numpy(iy.astype(dt)), torch.from_numpy(ix.astype(dt)),
        torch.from_numpy(sig), torch.from_numpy(theta)).numpy()
    assert np.abs(jd - td).max() <= _tol(dt, "msurf")


def test_top_k_stable_orders_ties_as_jax():
    """Equal scores (every invalid slot scores 0) in ascending index, as
    jax.lax.top_k gives them."""
    import jax
    s = np.array([0.0, 2.0, 0.0, 1.0, 2.0, 0.0, 0.0, 3.0, 0.0], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 7)
    tv, ti = ta._top_k_stable(torch.from_numpy(s), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("seed", [0, 3])
def test_extract_akaze_matches_jax(seed):
    img = make_test_image(np.random.default_rng(seed))
    jk, jd, jv = ja.extract_akaze(img, ja.AkazeOptions(**OPTS))
    tk, td, tv = ta.extract_akaze(img, ta.AkazeOptions(**OPTS),
                                  device="cpu")
    assert tk.dtype == np.float32 and td.dtype == np.float32
    assert tk.shape == jk.shape and td.shape == jd.shape
    # the valid keypoints as sets of (level, row, column)
    key = lambda k, v: {(round(float(s), 4), int(y), int(x))  # noqa: E731
                        for x, y, s in k[v][:, :3]}
    assert key(tk, tv) == key(jk, jv)
    np.testing.assert_array_equal(tv, jv)      # and in JAX's order
    np.testing.assert_allclose(tk[tv, :3], jk[jv, :3], atol=1e-5)
    np.testing.assert_allclose(tk[tv, 3], jk[jv, 3], atol=1e-4)
    np.testing.assert_allclose(td[tv], jd[jv], atol=1e-4)


def test_descriptor_extractor_factory():
    img = make_test_image(np.random.default_rng(1), 128)
    for kind, D in (("AKAZE", 64), ("SIFT", 128)):
        k, d, v = create_descriptor_extractor(kind, "SPARSE",
                                              device="cpu")(img)
        assert d.shape[1] == D and v.any()
    with pytest.raises(ValueError):
        create_descriptor_extractor("ORB", device="cpu")


def test_akaze_detects(rng):
    """JAX's test_akaze_detects through the port."""
    img = make_test_image(rng)
    kps, desc, valid = ta.extract_akaze(img, ta.AkazeOptions(**OPTS),
                                        device="cpu")
    assert valid.sum() > 40, valid.sum()
    np.testing.assert_allclose(np.linalg.norm(desc[valid], axis=-1), 1.0,
                               atol=1e-4)


def test_akaze_translation_matching(rng):
    """JAX's test_akaze_translation_matching through the port (its
    brute-force matcher)."""
    img = make_test_image(rng)
    shift = 16
    img2 = np.roll(img, (shift, shift), axis=(0, 1))
    o = ta.AkazeOptions(**OPTS)
    kp1, d1, v1 = ta.extract_akaze(img, o, device="cpu")
    kp2, d2, v2 = ta.extract_akaze(img2, o, device="cpu")
    idx2, valid, _ = match_descriptors(
        torch.from_numpy(d1), torch.from_numpy(d2),
        mask1=torch.from_numpy(v1), mask2=torch.from_numpy(v2),
        lowes_ratio=0.85)
    idx2, valid = idx2.numpy(), valid.numpy()
    sel = np.nonzero(valid)[0]
    assert len(sel) > 20, len(sel)
    d = kp2[idx2[sel], :2] - kp1[sel, :2]
    good = (np.abs(d - shift) < 2.0).all(axis=-1)
    assert good.mean() > 0.7, good.mean()
