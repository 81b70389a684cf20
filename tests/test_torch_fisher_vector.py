"""The port's Fisher-vector GMM, encodings and pair selection against the
JAX package's, in float32 on the CPU (both packages train in float32),
with the GMM's initial means taken from the rows JAX's key draws.
Tolerances: GMM parameters to 2e-4 relative, encodings to 2e-5, the
selected pairs equal."""
import jax
import numpy as np
import torch

from theiasfm_tpu.matching import fisher_vector as jfv
from theiasfm_tpu_torch.matching import fisher_vector as tfv


def _images(rng, n_images=10, per=60, D=32, K=4):
    """Descriptors of n_images 'images' drawn around K cluster centres,
    each image favouring two of them (so neighbours differ)."""
    centres = rng.normal(size=(K, D)) * 3.0
    out = {}
    for i in range(n_images):
        a, b = i % K, (i // 2) % K
        lab = rng.choice([a, b], size=per)
        out[f"img{i:02d}"] = (centres[lab] + rng.normal(size=(per, D))
                              ).astype(np.float32)
    return out


def test_fisher_vectors_match_jax():
    rng = np.random.default_rng(0)
    imgs = _images(rng)
    opts = jfv.FisherVectorOptions(num_gmm_clusters=4,
                                   max_num_features_for_training=500,
                                   em_iterations=8)
    topts = tfv.FisherVectorOptions(**vars(opts))
    X = np.concatenate(list(imgs.values()))
    j = jfv.FisherVectorExtractor(opts, seed=3)
    j.train(X)
    # the initial means JAX's key draws from the 500 subsampled rows
    init = np.array(jax.random.choice(j.key, 500, (4,), replace=False))
    t = tfv.FisherVectorExtractor(topts, device="cpu")
    t.train(X, init_indices=init)
    for a, b in zip(t.gmm, j.gmm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    gj = {n: j.extract_global_descriptor(d) for n, d in imgs.items()}
    gt = {n: t.extract_global_descriptor(d) for n, d in imgs.items()}
    for n in imgs:
        np.testing.assert_allclose(gt[n], gj[n], rtol=0, atol=2e-5)
    mask = np.arange(60) < 40
    np.testing.assert_allclose(
        t.extract_global_descriptor(imgs["img00"], mask),
        j.extract_global_descriptor(imgs["img00"], mask), rtol=0, atol=2e-5)
    for k, qe in ((2, True), (3, False)):
        pt = tfv.select_image_pairs_from_global_descriptors(gt, k, qe)
        pj = jfv.select_image_pairs_from_global_descriptors(gj, k, qe)
        assert pt == pj
        assert 0 < len(pt) < 45


def test_generator_draws_distinct_initial_means():
    """Without init_indices the initial means are distinct rows drawn
    from the extractor's generator: the same seed gives the same GMM."""
    X = np.concatenate(list(_images(np.random.default_rng(1)).values()))
    opts = tfv.FisherVectorOptions(num_gmm_clusters=4, em_iterations=3)
    a, b = (tfv.FisherVectorExtractor(opts, seed=5, device="cpu")
            for _ in range(2))
    a.train(X)
    b.train(X)
    for x, y in zip(a.gmm, b.gmm):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert np.isfinite(a.extract_global_descriptor(X[:50])).all()


def test_initial_means_drawn_on_the_cpu_for_every_device(monkeypatch):
    """The GMM's initial rows come from a CPU generator whatever the
    extractor's device, as JAX's draw is the same on every platform: a
    CUDA generator streams other rows, and the card then chose other
    image pairs than the CPU from the same features (24 views: 4 pairs
    only on the card, models at 0.17-0.18 px against 0.11-0.13;
    tests/frontend24_probe.py)."""
    monkeypatch.setattr(tfv, "resolve_device", torch.device)
    opts = tfv.FisherVectorOptions(num_gmm_clusters=16)
    card = tfv.FisherVectorExtractor(opts, seed=5, device="cuda")
    cpu = tfv.FisherVectorExtractor(opts, seed=5, device="cpu")
    assert card.device.type == "cuda"
    assert card.generator.device.type == "cpu"
    a, b = card.initial_indices(36_000), cpu.initial_indices(36_000)
    assert a.shape == (16,) and len(set(a.tolist())) == 16
    assert torch.equal(a, b)
