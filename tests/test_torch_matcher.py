"""The port's matchers against the JAX package's on the CPU:
fused_matcher.top2_plain and the fused wrappers (the top2_match kernel's
plain route) against the Pallas matcher run with interpret=True, and
brute_force against brute_force.

Tolerances (the same as chip_smoke.py's matcher_kernels phase) and why:
the two sides sum the float32 dot products in another order, so
* idx is identical except at near-ties, |best − second| ≤ 1e-5·|best|;
* best and second agree to 1e-5 of the largest entry;
* valid is identical except where the ratio best/second is within 1e-5
  of lowes_ratio², on at most 0.1% of rows.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from theiasfm_tpu.matching import brute_force as jbf
from theiasfm_tpu.matching import pallas_matcher as jpm
from theiasfm_tpu_torch.matching import brute_force as tbf
from theiasfm_tpu_torch.matching import fused_matcher as tfm

RATIO = 0.8


def _descs(rng, n1, n2, d, shared=0.6):
    """Queries, and keys of which a share are noisy copies of queries."""
    d1 = rng.normal(size=(n1, d)).astype(np.float32)
    d2 = rng.normal(size=(n2, d)).astype(np.float32)
    k = int(shared * min(n1, n2))
    src = rng.permutation(n1)[:k]
    dst = rng.permutation(n2)[:k]
    d2[dst] = d1[src] + 0.3 * rng.normal(size=(k, d)).astype(np.float32)
    return d1, d2


def _ref_top2(d1, d2, mask2=None):
    """float64 best and second of the full squared distances."""
    a, b = d1.astype(np.float64), d2.astype(np.float64)
    dist = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None] - 2 * a @ b.T
    if mask2 is not None:
        dist = np.where(mask2[None], dist, np.inf)
    part = np.sort(dist, axis=1)[:, :2]
    return part[:, 0], part[:, 1]


def _assert_agree(got, ref, d1, d2, mask2=None, ratio_rows=None):
    """got/ref: (idx, valid or None, best[, second]) numpy, one pair."""
    b64, s64 = _ref_top2(d1, d2, mask2)
    near_tie = np.abs(s64 - b64) <= 1e-5 * np.abs(b64)
    assert (got[0] == ref[0])[~near_tie].all()
    for g, r in zip(got[2:], ref[2:]):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
    if got[1] is not None:
        diff = got[1] != ref[1]
        near = np.abs(b64 / s64 - RATIO ** 2) <= 1e-5
        if ratio_rows is not None:
            near = near | ratio_rows
        assert (~diff | near | near_tie).all()
        assert diff.sum() <= 1e-3 * diff.size


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask2"])
def test_top2_plain_matches_pallas_top2(masked):
    """Unbatched kernel 6 (_pallas_top2, tile-multiple shapes)."""
    rng = np.random.default_rng(0)
    d1, d2 = _descs(rng, 256, 1024, 64)
    n2 = (d2 * d2).sum(-1)
    mask2 = rng.random(1024) > 0.2 if masked else None
    if masked:
        n2 = np.where(mask2, n2, 1e30).astype(np.float32)
    jb, js, ji = _np(*jpm._pallas_top2(jnp.asarray(d1), jnp.asarray(d2),
                                      jnp.asarray(n2[None]), interpret=True))
    tb, ts, ti = (x[0].numpy() for x in tfm.top2_plain(
        torch.from_numpy(d1[None]), torch.from_numpy(d2[None]),
        torch.from_numpy(n2[None])))
    assert ti.dtype == np.int32
    n1 = (d1 * d1).sum(-1)
    _assert_agree((ti, None, tb + n1, ts + n1),
                  (ji[:, 0], None, jb[:, 0] + n1, js[:, 0] + n1),
                  d1, d2, mask2)


def test_top2_plain_matches_pallas_top2_batched():
    """Batched kernel 7 (_pallas_top2_batched), one pair per index."""
    rng = np.random.default_rng(1)
    pairs = [_descs(rng, 128, 512, 32) for _ in range(3)]
    d1 = np.stack([p[0] for p in pairs])
    d2 = np.stack([p[1] for p in pairs])
    n2 = (d2 * d2).sum(-1)
    n2[1, 400:] = 1e30
    jb, js, ji = _np(*jpm._pallas_top2_batched(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(n2[:, None]),
        interpret=True))
    tb, ts, ti = (x.numpy() for x in tfm.top2_plain(
        *map(torch.from_numpy, (d1, d2, n2))))
    for b in range(3):
        n1 = (d1[b] * d1[b]).sum(-1)
        m2 = n2[b] < 1e29
        _assert_agree((ti[b], None, tb[b] + n1, ts[b] + n1),
                      (ji[b, :, 0], None, jb[b, :, 0] + n1,
                       js[b, :, 0] + n1), d1[b], d2[b], m2)


@pytest.mark.parametrize("masks", ["none", "mask1", "mask2", "both"])
def test_fused_matches_pallas(masks):
    """match_descriptors_fused against match_descriptors_pallas on a
    ragged pair (300 queries, 200 keys: neither a tile multiple)."""
    rng = np.random.default_rng(2)
    d1, d2 = _descs(rng, 300, 200, 128)
    m1 = rng.random(300) > 0.1 if masks in ("mask1", "both") else None
    m2 = rng.random(200) > 0.1 if masks in ("mask2", "both") else None
    jm = [None if m is None else jnp.asarray(m) for m in (m1, m2)]
    ref = _np(*jpm.match_descriptors_pallas(
        jnp.asarray(d1), jnp.asarray(d2), *jm, lowes_ratio=RATIO,
        interpret=True))
    tm = [None if m is None else torch.from_numpy(m) for m in (m1, m2)]
    got = [x.numpy() for x in tfm.match_descriptors_fused(
        torch.from_numpy(d1), torch.from_numpy(d2), *tm, lowes_ratio=RATIO)]
    assert got[1].sum() > 50
    _assert_agree(got, ref, d1, d2, m2)


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nosym"])
def test_fused_batch_matches_pallas_batch(symmetric):
    """match_descriptors_fused_batch against
    match_descriptors_pallas_batch: three pairs of 200 rows, mask1 and
    mask2, and one ragged pair (keys past 150 masked)."""
    rng = np.random.default_rng(3)
    B, N, D = 3, 200, 128
    pairs = [_descs(rng, N, N, D) for _ in range(B)]
    d1 = np.stack([p[0] for p in pairs])
    d2 = np.stack([p[1] for p in pairs])
    m1 = rng.random((B, N)) > 0.05
    m2 = rng.random((B, N)) > 0.05
    m2[1, 150:] = False
    ref = _np(*jpm.match_descriptors_pallas_batch(
        *map(jnp.asarray, (d1, d2, m1, m2)), lowes_ratio=RATIO,
        symmetric=symmetric, interpret=True))
    got = [x.numpy() for x in tfm.match_descriptors_fused_batch(
        *map(torch.from_numpy, (d1, d2, m1, m2)), lowes_ratio=RATIO,
        symmetric=symmetric)]
    for b in range(B):
        assert got[1][b].sum() > 50
        _assert_agree([g[b] for g in got], [r[b] for r in ref],
                      d1[b], d2[b], m2[b])


def test_duplicate_keys_masked():
    """JAX's test_pallas_matcher_mask2: with the duplicate half of the
    keys masked, every row matches its own copy, exactly."""
    rng = np.random.default_rng(4)
    d1 = rng.normal(size=(64, 32)).astype(np.float32)
    d2 = np.concatenate([d1, d1])
    mask2 = np.zeros(128, bool)
    mask2[:64] = True
    idx, _, _ = tfm.match_descriptors_fused(
        torch.from_numpy(d1), torch.from_numpy(d2),
        mask2=torch.from_numpy(mask2))
    assert (idx.numpy() == np.arange(64)).all()
    ref, _, _ = jpm.match_descriptors_pallas(
        jnp.asarray(d1), jnp.asarray(d2), mask2=jnp.asarray(mask2),
        interpret=True)
    assert (np.asarray(ref) == np.arange(64)).all()


def test_exact_tie_takes_lowest_index():
    """Keys 5 and 40 (and 300, in another key tile of the TPU kernel)
    are the same vector: the lowest index wins, and the duplicate is the
    second distance, in every matcher."""
    rng = np.random.default_rng(5)
    d2 = rng.normal(size=(600, 16)).astype(np.float32)
    d2[40] = d2[5]
    d2[300] = d2[5]
    d1 = d2[[5, 7]] + np.float32(0.01)
    n2 = (d2 * d2).sum(-1)
    tb, ts, ti = (x[0].numpy() for x in tfm.top2_plain(
        torch.from_numpy(d1[None]), torch.from_numpy(d2[None]),
        torch.from_numpy(n2[None])))
    assert ti[0] == 5 and ts[0] == tb[0]
    pad = np.zeros((128, 16), np.float32)
    pad[:2] = d1
    n2p = np.full(1024, 1e30, np.float32)
    n2p[:600] = n2
    d2p = np.zeros((1024, 16), np.float32)
    d2p[:600] = d2
    jb, js, ji = _np(*jpm._pallas_top2(jnp.asarray(pad), jnp.asarray(d2p),
                                      jnp.asarray(n2p[None]),
                                      interpret=True))
    assert ji[0, 0] == 5 and js[0, 0] == jb[0, 0]
    for fn in (tbf.match_descriptors, tfm.match_descriptors_fused):
        idx, valid, _ = fn(torch.from_numpy(d1), torch.from_numpy(d2))
        assert idx[0] == 5 and not valid[0]   # ratio 1 fails the test
        assert idx[1] == 7


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nosym"])
@pytest.mark.parametrize("masks", [False, True], ids=["nomask", "masks"])
def test_brute_force_matches_jax(symmetric, masks):
    rng = np.random.default_rng(6)
    d1, d2 = _descs(rng, 250, 180, 64)
    m1 = rng.random(250) > 0.1 if masks else None
    m2 = rng.random(180) > 0.1 if masks else None
    jm = [None if m is None else jnp.asarray(m) for m in (m1, m2)]
    ref = _np(*jbf.match_descriptors(jnp.asarray(d1), jnp.asarray(d2), *jm,
                                     lowes_ratio=RATIO, symmetric=symmetric))
    tm = [None if m is None else torch.from_numpy(m) for m in (m1, m2)]
    got = [x.numpy() for x in tbf.match_descriptors(
        torch.from_numpy(d1), torch.from_numpy(d2), *tm, lowes_ratio=RATIO,
        symmetric=symmetric)]
    assert got[0].dtype == np.int32 and got[1].sum() > 50
    _assert_agree(got, ref, d1, d2, m2)


def test_brute_force_batch_matches_jax():
    rng = np.random.default_rng(7)
    pairs = [_descs(rng, 160, 160, 64) for _ in range(3)]
    d1 = np.stack([p[0] for p in pairs])
    d2 = np.stack([p[1] for p in pairs])
    m1 = rng.random((3, 160)) > 0.1
    m2 = rng.random((3, 160)) > 0.1
    m2[2, 100:] = False
    ref = _np(*jbf.match_descriptors_batch(*map(jnp.asarray,
                                                (d1, d2, m1, m2))))
    got = [x.numpy() for x in tbf.match_descriptors_batch(
        *map(torch.from_numpy, (d1, d2, m1, m2)))]
    for b in range(3):
        _assert_agree([g[b] for g in got], [r[b] for r in ref],
                      d1[b], d2[b], m2[b])
    # the fused batch matcher stores the same matches as the brute force
    fused = [x.numpy() for x in tfm.match_descriptors_fused_batch(
        *map(torch.from_numpy, (d1, d2, m1, m2)))]
    for b in range(3):
        _assert_agree([f[b] for f in fused], [g[b] for g in got],
                      d1[b], d2[b], m2[b])


def test_top2_refuses_other_devices():
    d = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="CPU .* or on CUDA"):
        tfm.top2(d, d, torch.zeros((1, 4), device="meta"))
