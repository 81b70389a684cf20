"""The port's batched geometric verification and guided matcher against
the JAX package's on the CPU.

No torch generator reproduces JAX's random stream, so the comparisons
hand the port the sample indices JAX draws (its key chain:
jax.random.split per pair, then (k1, k2) for the essential and the
homography samples; tests/torch_verification_cases.py) and run the
port in float64 as JAX runs under the suite's x64 mode. With the same
samples the two must accept the same pairs with equal verified counts,
homography inlier counts and visibility scores, and poses within 1e-6.
The guided matcher's indices and validity must be equal (on inputs
without exact distance ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.matching import guided_matcher as jgm
from theiasfm_tpu.sfm.pipeline import geometric_verification as jgv
from theiasfm_tpu_torch.matching import guided_matcher as tgm
from theiasfm_tpu_torch.sfm.pipeline import geometric_verification as tgv
from theiasfm_tpu_torch.sfm.pipeline import twoview as ttv
from torch_verification_cases import (F64, H, assert_same_infos, batch,
                                      jax_batch_samples)


@pytest.mark.parametrize("ba", [True, False], ids=["ba", "no_ba"])
def test_verify_matches_batch_matches_jax(ba):
    """Same samples: same accepted pairs (the garbage and the all-
    padding pair rejected by both, without raising), equal counts,
    poses within 1e-6, equal correspondences."""
    pix1, pix2, mask, f, pps, sizes = batch(np.random.default_rng(0))
    key = jax.random.PRNGKey(3)
    ev = dict(num_hypotheses=H)
    jo = jgv.GeometricVerificationOptions(
        estimate_twoview_info=jgv.TwoViewInfoOptions(**ev),
        bundle_adjustment=ba)
    to = tgv.GeometricVerificationOptions(
        estimate_twoview_info=ttv.TwoViewInfoOptions(**ev),
        bundle_adjustment=ba)
    ji, jc = jgv.verify_matches_batch(key, pix1, pix2, mask, f, f, pps,
                                      pps, sizes, jo)
    ti, tc = tgv.verify_matches_batch(jax_batch_samples(key, mask), pix1,
                                      pix2, mask, f, f, pps, pps, sizes,
                                      to, dtype=F64, device="cpu")
    assert ti[0] is not None and ti[1] is not None
    assert ti[2] is None and ti[3] is None
    assert_same_infos(ji, ti, jc, tc)
    # float32 from the port's own generator: no raise, the scenes pass
    ti32, _ = tgv.verify_matches_batch(torch.Generator().manual_seed(0),
                                       pix1, pix2, mask, f, f, pps, pps,
                                       sizes, to, device="cpu")
    assert [i is None for i in ti32] == [False, False, True, True]


def test_guided_matcher_matches_jax():
    rng = np.random.default_rng(2)
    n1, n2, D = 90, 110, 16
    kp1 = rng.uniform(0, 640, (n1, 2))
    kp2 = rng.uniform(0, 640, (n2, 2))
    F = rng.normal(size=(3, 3)) * np.array([1e-6, 1e-6, 1e-3])[:, None]
    d1 = rng.normal(size=(n1, D)).astype(np.float32)
    d2 = rng.normal(size=(n2, D)).astype(np.float32)
    m1, m2 = rng.random(n1) < 0.9, rng.random(n2) < 0.9
    md1, md2 = rng.random(n1) < 0.1, rng.random(n2) < 0.1
    for band in (4.0, 60.0):
        ji, jv = jgm.guided_epipolar_matching(
            *map(jnp.asarray, (F, kp1, kp2, d1, d2, m1, m2, md1, md2)),
            band_pixels=band)
        ti, tv = tgm.guided_epipolar_matching(
            *map(torch.from_numpy, (F, kp1, kp2, d1, d2, m1, m2, md1,
                                    md2)), band_pixels=band)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        sel = np.asarray(jv)
        assert sel.any()
        np.testing.assert_array_equal(ti.numpy()[sel], np.asarray(ji)[sel])
