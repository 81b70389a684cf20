"""The port's guided batched verification, single-pair verification and
two-view estimation against the JAX package's on the CPU, with JAX's
sample indices and in float64 (see tests/test_torch_verification.py for
the method): the same accepted pairs, equal counts and visibility
scores, poses within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.pipeline import geometric_verification as jgv
from theiasfm_tpu.sfm.pipeline import twoview as jtv
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch.sfm.pipeline import geometric_verification as tgv
from theiasfm_tpu_torch.sfm.pipeline import twoview as ttv
from torch_verification_cases import (F64, H, PP, assert_same_infos, batch,
                                      jax_batch_samples, pair)


def test_verify_matches_batch_guided_matches_jax():
    """Guided matching grows the set as JAX's does from the same
    samples."""
    rng = np.random.default_rng(1)
    pix1, pix2, _ = pair(rng, n_pts=200, n_out=20)
    n_put, n_feat, D = 120, 220, 32
    desc = rng.normal(size=(n_feat, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    args = (pix1[None, :n_put], pix2[None, :n_put],
            np.ones((1, n_put), bool), np.full(1, 600.0), np.full(1, 600.0),
            np.asarray(PP)[None], np.asarray(PP)[None],
            np.array([[[640, 480], [640, 480]]], float))
    kw = dict(kp1_all=pix1[None, :n_feat], kp2_all=pix2[None, :n_feat],
              desc1=desc[None], desc2=desc[None],
              fmask1=np.ones((1, n_feat), bool),
              fmask2=np.ones((1, n_feat), bool))
    key = jax.random.PRNGKey(5)
    ji, jc = jgv.verify_matches_batch(
        key, *args, jgv.GeometricVerificationOptions(
            estimate_twoview_info=jgv.TwoViewInfoOptions(num_hypotheses=H),
            guided_matching=True), **kw)
    ti, tc = tgv.verify_matches_batch(
        jax_batch_samples(key, args[2]), *args,
        tgv.GeometricVerificationOptions(
            estimate_twoview_info=ttv.TwoViewInfoOptions(num_hypotheses=H),
            guided_matching=True), **kw, dtype=F64, device="cpu")
    assert ti[0].num_verified_matches >= n_put
    assert_same_infos(ji, ti, jc, tc)


@pytest.mark.parametrize("guided", [False, True],
                         ids=["plain", "guided"])
def test_verify_matches_single_pair_matches_jax(guided):
    """The single-pair path: homography count from JAX's k_h samples,
    estimation from its key, the same accepted result."""
    rng = np.random.default_rng(6)
    pix1, pix2, _ = pair(rng)
    key = jax.random.PRNGKey(11)
    opts = dict(estimate_twoview_info=jgv.TwoViewInfoOptions(
        num_hypotheses=H), guided_matching=guided)
    kw = {}
    if guided:
        desc = rng.normal(size=(len(pix1), 16)).astype(np.float32)
        kw = dict(kp1_all=pix1, kp2_all=pix2, desc1=desc, desc2=desc)
    size = (640, 480)
    ji, jc = jgv.verify_matches(key, pix1, pix2, 600.0, 600.0, PP, PP,
                                jgv.GeometricVerificationOptions(**opts),
                                image_size1=size, image_size2=size, **kw)
    k_rest, k_h = jax.random.split(key)
    N = 256
    m = jnp.arange(N) < len(pix1)
    samples = tgv.VerificationSamples(
        essential=torch.from_numpy(np.array(jrs(k_rest, N, 5, H, m))),
        homography=torch.from_numpy(np.array(jrs(k_h, N, 4, H, m))))
    opts["estimate_twoview_info"] = ttv.TwoViewInfoOptions(num_hypotheses=H)
    ti, tc = tgv.verify_matches(samples, pix1, pix2, 600.0, 600.0, PP, PP,
                                tgv.GeometricVerificationOptions(**opts),
                                image_size1=size, image_size2=size,
                                dtype=F64, device="cpu", **kw)
    assert ti is not None
    assert_same_infos([ji], [ti], [jc], [tc])
    assert tgv.count_homography_inliers(
        samples.homography, pix1, pix2, 2.25, size, size, H,
        dtype=F64, device="cpu") == ji.num_homography_inliers
    # a generator runs it end to end in float32
    ti32, _ = tgv.verify_matches(torch.Generator().manual_seed(0), pix1,
                                 pix2, 600.0, 600.0, PP, PP,
                                 tgv.GeometricVerificationOptions(**opts),
                                 device="cpu")
    assert ti32 is not None and ti32.num_verified_matches >= 140


def test_estimate_twoview_info_matches_jax():
    rng = np.random.default_rng(3)
    pix1, pix2, aa = pair(rng)
    key = jax.random.PRNGKey(9)
    opts = dict(num_hypotheses=H)
    N = 256   # the bucket _pad_pair pads 190 matches to
    idx = torch.from_numpy(np.array(jrs(
        key, N, 5, H, jnp.arange(N) < len(pix1))))
    ji, jinl = jtv.estimate_twoview_info(
        key, jnp.asarray(pix1), jnp.asarray(pix2), 600.0, 600.0,
        jtv.TwoViewInfoOptions(**opts), pp1=PP, pp2=PP)
    ti, tinl = ttv.estimate_twoview_info(
        idx, pix1, pix2, 600.0, 600.0, ttv.TwoViewInfoOptions(**opts),
        pp1=PP, pp2=PP, dtype=F64, device="cpu")
    np.testing.assert_array_equal(tinl, np.asarray(jinl))
    assert ti.num_verified_matches == ji.num_verified_matches >= 140
    np.testing.assert_allclose(ti.rotation_2, ji.rotation_2, atol=1e-6)
    np.testing.assert_allclose(ti.position_2, ji.position_2, atol=1e-6)
    # batched
    pix1b, pix2b, mask, f, pps, _ = batch(np.random.default_rng(4))
    keys = jax.random.split(key, 4)
    idxb = torch.from_numpy(np.stack([np.asarray(jrs(
        k, 256, 5, H, jnp.asarray(mask[p]))) for p, k in enumerate(keys)]))
    jb, jbin = jtv.estimate_twoview_info_batch(
        key, pix1b, pix2b, mask, f, f, pps, pps,
        jtv.TwoViewInfoOptions(**opts))
    tb, tbin = ttv.estimate_twoview_info_batch(
        idxb, pix1b, pix2b, mask, f, f, pps, pps,
        ttv.TwoViewInfoOptions(**opts), dtype=F64, device="cpu")
    np.testing.assert_array_equal(tbin, np.asarray(jbin))
    assert [i is None for i in tb] == [i is None for i in jb]
    for a, b in zip(jb, tb):
        if a is not None:
            assert b.num_verified_matches == a.num_verified_matches
            np.testing.assert_allclose(b.rotation_2, a.rotation_2,
                                       atol=1e-6)
