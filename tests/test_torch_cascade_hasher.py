"""The port's cascade hasher (matching/cascade_hasher.py) and the
feature matcher's cascade branch against the JAX package's, on the CPU.

Given JAX's projection basis (convert.cascade_hasher_from_state) the
port's hashes equal JAX's packed uint32 words bit for bit, its Hamming
matrix (one +-1 float32 product) equals JAX's XOR + popcount on every
entry, and the candidates, matches and distances equal JAX's, also
where Hamming distances tie (JAX's top_k takes the lower index first;
the port selects on the unique key ham * N2 + j). The distances of the
matches agree to 1e-6 (float32 sums in another order; measured 2.4e-7
at most). The port's own basis (a torch generator) is another draw, so
on its own it is held to JAX's test_cascade_hasher_matches_brute_force
bounds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_matching import make_descriptors
from test_torch_feature_matcher import _features, _jax_db
from theiasfm_tpu.matching import cascade_hasher as jch
from theiasfm_tpu.matching import feature_matcher as jfm
from theiasfm_tpu_torch import convert
from theiasfm_tpu_torch.matching import cascade_hasher as tch
from theiasfm_tpu_torch.matching import feature_matcher as tfm

from torch_sfm_cases import one_torch_thread  # noqa: F401

DIST_TOL = 1e-6


def _popcount_hamming(h1, h2):
    """JAX's Hamming matrix from its packed words, in numpy."""
    x = np.asarray(h1)[:, None, :] ^ np.asarray(h2)[None, :, :]
    return np.vectorize(lambda w: int(w).bit_count())(x).sum(-1)


def _hashers(seed=1, K=16, D=128):
    j = jch.CascadeHasher(D, seed=seed, num_candidates=K)
    t = convert.cascade_hasher_from_state(np.asarray(j.proj), K,
                                          device="cpu")
    return j, t


def test_hashes_equal_jax_with_its_basis(rng):
    d = make_descriptors(rng, n=300)
    mean = d.mean(0)
    j, t = _hashers()
    jw = np.asarray(j.hash_descriptors(jnp.asarray(d), jnp.asarray(mean)))
    tw = t.hash_descriptors(torch.from_numpy(d), mean).numpy()
    np.testing.assert_array_equal(tw, jw.astype(np.int64))


def test_hamming_equals_xor_popcount(rng):
    d1, d2 = make_descriptors(rng, n=120), make_descriptors(rng, n=90)
    mean = np.concatenate([d1, d2]).mean(0)
    j, t = _hashers()
    h1 = j.hash_descriptors(jnp.asarray(d1), jnp.asarray(mean))
    h2 = j.hash_descriptors(jnp.asarray(d2), jnp.asarray(mean))
    s1 = tch._signs(t.hash_bits(torch.from_numpy(d1), mean))
    s2 = tch._signs(t.hash_bits(torch.from_numpy(d2), mean))
    ham = tch.hamming(s1, s2).numpy()
    np.testing.assert_array_equal(ham, _popcount_hamming(h1, h2))
    assert ham.min() >= 0 and ham.max() <= 128


def _pack(bits):
    w = bits.reshape(*bits.shape[:-1], 4, 32).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tied_candidates_ordered_as_jax(seed):
    """Only four distinct codes among 60 keys: every query ties across
    many candidates, and which K enter decides the match. Some keys are
    masked, and one query row sees fewer unmasked keys than K."""
    g = np.random.default_rng(seed)
    N1, N2, K = 24, 60, 5
    codes = g.random((4, 128)) > 0.5
    b1 = codes[g.integers(0, 4, N1)]
    b1[:, :3] ^= g.random((N1, 3)) > 0.5       # a few bits off the codes
    b2 = codes[g.integers(0, 4, N2)]
    d1 = g.normal(size=(N1, 64)).astype(np.float32)
    d2 = g.normal(size=(N2, 64)).astype(np.float32)
    m1 = g.random(N1) > 0.1
    m2 = g.random(N2) > 0.2
    one = np.zeros(N2, bool)
    one[7] = True                     # a single unmasked key
    for m2 in (m2, one):
        jout = jch._cascade_match(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(_pack(b1)),
            jnp.asarray(_pack(b2)), jnp.asarray(m1), jnp.asarray(m2), K, 0.9)
        tout = tch._cascade_match(
            torch.from_numpy(d1), torch.from_numpy(d2),
            tch._signs(torch.from_numpy(b1)),
            tch._signs(torch.from_numpy(b2)),
            torch.from_numpy(m1), torch.from_numpy(m2), K, 0.9)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                   rtol=DIST_TOL)


def test_cascade_hasher_matches_brute_force(rng):
    """JAX's test_cascade_hasher_matches_brute_force: with JAX's basis
    the same matches as JAX; with the port's own basis JAX's bounds."""
    d1 = make_descriptors(rng, n=300)
    perm = rng.permutation(300)
    d2 = d1[perm] + 0.005 * rng.normal(size=d1.shape).astype(np.float32)
    mean = np.concatenate([d1, d2]).mean(0)
    j, t = _hashers(seed=1, K=16)
    ji, jv, jd = (np.asarray(x) for x in j.match(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mean)))
    ti, tv, td = (x.numpy() for x in t.match(
        torch.from_numpy(d1), torch.from_numpy(d2), mean))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(td, jd, rtol=DIST_TOL)
    own = tch.CascadeHasher(128, seed=1, num_candidates=16, device="cpu")
    idx2, valid, _ = (x.numpy() for x in own.match(
        torch.from_numpy(d1), torch.from_numpy(d2), mean))
    inv = np.argsort(perm)
    assert valid.mean() > 0.9
    assert (idx2[valid] == inv[valid]).mean() > 0.99


def test_batched_match_equals_per_pair(rng):
    """The pair batch (the feature matcher's call) gives each pair's
    own result."""
    _, t = _hashers(K=8)
    d1 = np.stack([make_descriptors(rng, n=80) for _ in range(3)])
    d2 = np.stack([make_descriptors(rng, n=80) for _ in range(3)])
    m1 = rng.random((3, 80)) > 0.1
    m2 = rng.random((3, 80)) > 0.1
    mean = d1.reshape(-1, 128).mean(0)
    batch = t.match(*(torch.from_numpy(x) for x in (d1, d2)), mean,
                    torch.from_numpy(m1), torch.from_numpy(m2))
    for p in range(3):
        one = t.match(torch.from_numpy(d1[p]), torch.from_numpy(d2[p]), mean,
                      torch.from_numpy(m1[p]), torch.from_numpy(m2[p]))
        for a, b in zip(batch, one):
            np.testing.assert_array_equal(a[p].numpy(), b.numpy())


def test_feature_matcher_cascade_matches_jax():
    """FeatureMatcher(matcher="cascade_hashing") on 3 images in both
    packages, the port given JAX's basis: the same pairs and the same
    putative matches (no symmetric pass in either)."""
    features = _features(seed=2, n_images=3)
    opts = dict(matcher="cascade_hashing",
                perform_geometric_verification=False)
    jdb = _jax_db(features)
    jm = jfm.FeatureMatcher(jfm.FeatureMatcherOptions(**opts), jdb)
    tdb = convert.features_db_from_arrays(features)
    tm = tfm.FeatureMatcher(tfm.FeatureMatcherOptions(**opts), tdb,
                            device="cpu")
    tm._hasher = convert.cascade_hasher_from_state(
        np.asarray(jch.CascadeHasher(128, seed=0).proj), device="cpu")
    for m in (jm, tm):
        m.add_images(sorted(features))
    assert tm.match_images() == jm.match_images() == 3
    assert tdb.image_pairs_of_matches() == jdb.image_pairs_of_matches()
    for p in jdb.image_pairs_of_matches():
        cj = jdb.get_match(*p).correspondences
        ct = tdb.get_match(*p).correspondences
        assert {tuple(r) for r in ct} == {tuple(r) for r in cj}, p
    # the port's own basis, drawn once per matcher from its seed
    tdb2 = convert.features_db_from_arrays(features)
    own = tfm.FeatureMatcher(tfm.FeatureMatcherOptions(**opts), tdb2,
                             device="cpu")
    own.add_images(sorted(features))
    assert own.match_images() == 3
    assert own._hasher.proj.shape == (128, 128)
