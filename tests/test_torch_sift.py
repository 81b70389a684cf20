"""The port's SIFT (theiasfm_tpu_torch/image/sift.py) against the JAX
package's (theiasfm_tpu/image/sift.py) on the CPU: stage by stage on
identical inputs, then end to end.

Tolerances and why:
* _blur: 1e-6 absolute. Both convolve the same float32 taps; only the
  order of the float32 sums differs.
* _octave_keypoints: the same set of good voxels, and their refined
  positions to 1e-5. The DoG arithmetic is the same elementwise float32
  code, so only a voxel within rounding of a threshold could flip; on
  these inputs none does, so the sets must be equal.
* _keypoint_orientation 1e-4 rad and _descriptors 1e-5: under the test
  suite's x64 mode the JAX descriptor samples its patch in float64
  (its grid is built from an int64 arange), the port in float32.
* End to end: 98% of valid keypoints matched both ways within 1e-3 px,
  and 98% of the matched descriptors within 1e-3 in L∞. The top-k order
  of equal scores may differ, so keypoints are compared as sets.
"""
import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp
import torch

from theiasfm_tpu.image import sift as jsift
from theiasfm_tpu_torch.image import sift as tsift

H, W = 128, 160
KW = dict(num_octaves=2, max_features_per_octave=64)


def _image(seed, h=H, w=W):
    """tests/test_sift.py's smooth random blob image at (h, w)."""
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.normal(size=(h, w)), 4.0)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


VARIANTS = {"classic": {}, "root_sift": {"root_sift": True},
            "upright": {"upright": True}}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX extractions, once per module: single image per variant, and
    one batch of two images."""
    imgs = [_image(0), _image(1)]
    out = {name: jsift.extract_sift(imgs[0], jsift.SiftOptions(**KW, **kw))
           for name, kw in VARIANTS.items()}
    out["batch"] = jsift.extract_sift_batch(imgs, jsift.SiftOptions(**KW))
    return imgs, out


def _t(x):
    return torch.from_numpy(np.array(x))


def test_blur_matches_jax():
    img = _image(2)
    for sigma in (0.8, 1.52, 2.5, 4.03):
        ref = np.asarray(jsift._blur(jnp.asarray(img), sigma))
        got = tsift._blur(_t(img), sigma).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # a batch written out as a leading dimension blurs each image alone
    both = np.stack([img, _image(3)])
    got = tsift._blur(_t(both), 1.52).numpy()
    ref = np.asarray(jsift._blur(jnp.asarray(both[1]), 1.52))
    np.testing.assert_allclose(got[1], ref, rtol=0, atol=1e-6)


def _gauss_stack(img, n=6):
    g = [jsift._blur(jnp.asarray(img), 1.52)]
    for s in range(1, n):
        g.append(jsift._blur(g[-1], 0.6 + 0.3 * s))
    return np.asarray(jnp.stack(g))


def test_min_max_pool_matches_jax():
    x = np.random.default_rng(4).normal(size=(5, 12, 17)).astype(np.float32)
    for got, ref in zip(tsift._min_max_pool3(_t(x)),
                        jsift._min_max_pool3(jnp.asarray(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_octave_keypoints_match_jax():
    """All good voxels (K larger than their number), as sets of (level,
    row, column), with the same refined position and score."""
    G = _gauss_stack(_image(5))
    opts_j = jsift.SiftOptions(max_features_per_octave=4096)
    opts_t = tsift.SiftOptions(max_features_per_octave=4096)
    rj = [np.asarray(a) for a in jsift._octave_keypoints(jnp.asarray(G),
                                                         opts_j)]
    rt = [a.numpy() for a in tsift._octave_keypoints(_t(G), opts_t)]

    def by_voxel(r):
        score, y, x, s, sl, iy, ix, valid = r
        assert valid.sum() < valid.size
        return {(int(a), int(b), int(c)): (sc, yy, xx, ss) for
                a, b, c, sc, yy, xx, ss in zip(sl[valid], iy[valid],
                                               ix[valid], score[valid],
                                               y[valid], x[valid], s[valid])}
    vj, vt = by_voxel(rj), by_voxel(rt)
    assert len(vj) > 20
    assert set(vj) == set(vt)
    for key, ref in vj.items():
        np.testing.assert_allclose(vt[key], ref, rtol=0, atol=1e-5)


def _patches(K=24, seed=6):
    rng = np.random.default_rng(seed)
    g = ndimage.gaussian_filter(rng.normal(size=(K, 2, 88, 88)),
                                (0, 0, 3, 3)).astype(np.float32)
    sigma = rng.uniform(1.6, 4.5, K).astype(np.float32)
    theta = rng.uniform(0, 2 * np.pi, K).astype(np.float32)
    dyk, dxk = rng.uniform(-0.5, 0.5, (2, K)).astype(np.float32)
    return g[:, 0], g[:, 1], sigma, theta, dyk, dxk


def test_orientation_and_descriptors_match_jax():
    pgx, pgy, sigma, theta, dyk, dxk = _patches()
    ref = np.asarray(jsift._keypoint_orientation(
        jnp.asarray(pgx), jnp.asarray(pgy), jnp.asarray(sigma)))
    got = tsift._keypoint_orientation(_t(pgx), _t(pgy), _t(sigma)).numpy()
    diff = np.angle(np.exp(1j * (got.astype(np.float64) - ref)))
    np.testing.assert_allclose(diff, 0, atol=1e-4)

    ref = np.asarray(jsift._descriptors(*map(jnp.asarray, (
        pgx, pgy, dyk, dxk, sigma, theta))))
    got = tsift._descriptors(*map(_t, (pgx, pgy, dyk, dxk, sigma,
                                       theta))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_extract_patches_match_jax():
    rng = np.random.default_rng(7)
    gx = rng.normal(size=(4, 40 + 88, 50 + 88)).astype(np.float32)
    gy = rng.normal(size=gx.shape).astype(np.float32)
    sl = np.array([1, 2, 3, 1], np.int32)
    iy = np.array([5, 17, 34, 0], np.int32)
    ix = np.array([5, 44, 0, 49], np.int32)
    ref = jsift._extract_patches(*map(jnp.asarray, (gx, gy, sl, iy, ix)))
    got = tsift._extract_patches(_t(gx), _t(gy), *(_t(a).long()
                                                   for a in (sl, iy, ix)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _agree(ref, got):
    """Valid keypoints matched both ways within 1e-3 px, and the matched
    descriptors within 1e-3 (L∞), each for at least 98%."""
    (kj, dj, vj), (kt, dt, vt) = ref, got
    assert kt.shape == kj.shape and dt.shape == dj.shape
    assert vj.sum() > 20
    a, da = kj[vj], dj[vj]
    b, db = kt[vt], dt[vt]
    dist = np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=-1)
    assert np.mean(dist.min(1) <= 1e-3) >= 0.98
    assert np.mean(dist.min(0) <= 1e-3) >= 0.98
    nn = dist.argmin(1)
    close = dist.min(1) <= 1e-3
    linf = np.abs(da[close] - db[nn[close]]).max(1)
    assert np.mean(linf <= 1e-3) >= 0.98


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_extract_sift_matches_jax(jax_runs, variant):
    imgs, ref = jax_runs
    got = tsift.extract_sift(imgs[0], tsift.SiftOptions(
        **KW, **VARIANTS[variant]), device="cpu")
    _agree(ref[variant], got)
    if variant == "upright":
        assert (got[0][got[2], 3] == 0).all()
    if variant == "root_sift":
        np.testing.assert_allclose(
            np.linalg.norm(got[1][got[2]], axis=-1), 1.0, atol=1e-5)


def test_extract_sift_batch_matches_jax(jax_runs):
    imgs, ref = jax_runs
    got = tsift.extract_sift_batch(imgs, tsift.SiftOptions(**KW),
                                   device="cpu")
    assert len(got) == 2
    for r, g in zip(ref["batch"], got):
        _agree(r, g)
    # the batch gives each image what a single extraction gives it
    single = tsift.extract_sift(imgs[1], tsift.SiftOptions(**KW),
                                device="cpu")
    _agree(single, got[1])


def test_extract_sift_batch_rejects_mixed_shapes():
    with pytest.raises(ValueError, match="same-shape"):
        tsift.extract_sift_batch([_image(0), _image(1, 64, 64)],
                                 device="cpu")
