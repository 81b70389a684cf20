"""The port's hybrid pipeline (theiasfm_tpu_torch/sfm/pipeline/hybrid.py)
and the builder's GLOBAL and HYBRID branches, on the CPU in float64 (the
suite's x64).

- position_from_rays_data_spec against the JAX spec on the same
  samples: the minimal solutions and the residuals to 1e-10, the six
  Gauss-Newton steps of the refinement to 1e-8.
- localize_views_known_orientation_batch with JAX's sample indices (the
  per-view keys JAX splits from its key) on the synthetic scene of
  tests/torch_sfm_cases.py: the same views localized, positions to
  1e-8 of the scene's scale.
- hybrid_reconstruction against JAX's, the port's rounds fed JAX's
  indices by a monkeypatch: the same estimated views and tracks,
  camera positions within 1e-6 of the scene's scale (the 8-unit camera
  distance).
- ReconstructionBuilder with the default options (GLOBAL) and with
  HYBRID, from injected matches of the same scene: one model of all 8
  views whose positions, aligned to the truth (JAX's
  sfm/transformation), are within 1% of the scene's scale; both
  branches hand the builder's dtype and device to their pipeline."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.pipeline import hybrid as jhy
from theiasfm_tpu.sfm.transformation import align_point_clouds
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu_torch.sfm import reconstruction_builder as trb
from theiasfm_tpu_torch.sfm.pipeline import hybrid as thy

import torch_sfm_cases as cases
from test_torch_reconstruction_builder import _port_builder
from torch_sfm_cases import one_torch_thread  # noqa: F401

CPU = dict(dtype=torch.float64, device="cpu")


def _rays_data(rng, N=30):
    R = cases.rotation(0.2 * rng.normal(size=3))
    c = rng.normal(size=3)
    world = rng.uniform(-2, 2, size=(N, 3)) + np.array([0, 0, 8.0])
    pc = (world - c) @ R.T
    image = pc[:, :2] / pc[:, 2:] + rng.normal(scale=1e-3, size=(N, 2))
    return world, image, R


def test_position_from_rays_spec_matches_jax():
    rng = np.random.default_rng(0)
    world, image, R = _rays_data(rng)
    N = len(world)
    tspec, jspec = thy.position_from_rays_data_spec(), \
        jhy.position_from_rays_data_spec()
    idx = rng.integers(0, N, size=(8, 2))
    idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, N - 1, 8)) % N
    Rn = np.broadcast_to(R, (N, 3, 3))
    tdata = {"world": torch.from_numpy(world)[None],
             "image": torch.from_numpy(image)[None],
             "R": torch.from_numpy(np.ascontiguousarray(Rn))[None]}
    sub = {k: v[:, torch.from_numpy(idx)] for k, v in tdata.items()}
    models, valid = tspec.solve(sub)
    assert models.shape == (1, 8, 1, 3) and bool(valid.all())
    jdata = {"world": jnp.asarray(world), "image": jnp.asarray(image),
             "R": jnp.asarray(Rn)}
    for h in range(8):
        jm, _ = jspec.solve({k: v[idx[h]] for k, v in jdata.items()})
        np.testing.assert_allclose(models[0, h].numpy(), np.asarray(jm),
                                   rtol=0, atol=1e-10)
    res = tspec.residuals(models[:, :, 0], tdata)
    for h in range(8):
        np.testing.assert_allclose(
            res[0, h].numpy(),
            np.asarray(jspec.residuals(jnp.asarray(models[0, h, 0].numpy()),
                                       jdata)), rtol=0, atol=1e-10)
    w = (rng.uniform(size=N) < 0.8).astype(float)
    got = tspec.refine(models[:, 0, 0], tdata, torch.from_numpy(w)[None])
    want = jspec.refine(jnp.asarray(models[0, 0, 0].numpy()), jdata,
                        jnp.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-8)


def jax_known_orientation_samples(key, batch, num_hypotheses):
    """The (V, H, 2) indices JAX's localize_views_known_orientation_batch
    draws from `key` for a prepared batch."""
    V, N = batch.mask.shape
    keys = jax.random.split(key, V)
    return torch.from_numpy(np.stack([
        np.array(jrs(keys[i], N, 2, num_hypotheses,
                     jnp.asarray(batch.mask[i]))) for i in range(V)]))


def _partly_estimated(sc):
    """Both packages' reconstructions at the true state with views 5-7
    unestimated at their true rotation and a wrong position."""
    jrec, trec = cases.reconstructions(sc)
    for rec in (jrec, trec):
        cases.set_true_state(sc, rec)
        for v in (5, 6, 7):
            rec.views[v].is_estimated = False
            rec.views[v].camera.extrinsics[:3] = 0.0
    return jrec, trec


def test_localize_known_orientation_batch_matches_jax():
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = _partly_estimated(sc)
    opts = thy.LocalizeOptions()
    key = jax.random.PRNGKey(3)
    batch = thy.prepare_known_orientation_batch(trec, [5, 6, 7], opts)
    assert batch.view_ids == [5, 6, 7]
    idx = jax_known_orientation_samples(key, batch, opts.num_hypotheses)
    got = thy.localize_views_known_orientation_batch(idx, trec, [5, 6, 7],
                                                     opts, **CPU)
    want = jhy.localize_views_known_orientation_batch(key, jrec, [5, 6, 7],
                                                      opts)
    assert got == want == {5: True, 6: True, 7: True}
    for v in (5, 6, 7):
        np.testing.assert_allclose(trec.views[v].camera.extrinsics,
                                   jrec.views[v].camera.extrinsics,
                                   rtol=0, atol=8e-8)
        np.testing.assert_allclose(trec.views[v].camera.extrinsics[:3],
                                   sc.extrinsics[v, :3], atol=0.05)


@pytest.fixture
def jax_samples(monkeypatch):
    """Make the port's hybrid pipeline localize with the indices JAX's
    draws: the same key splits per round, the same per-view keys."""
    real = thy.localize_views_known_orientation_batch
    state = {"key": jax.random.PRNGKey(0)}

    def localize(samples, recon, view_ids, opts, **kw):
        state["key"], k = jax.random.split(state["key"])
        batch = thy.prepare_known_orientation_batch(recon, view_ids, opts)
        if batch is None:
            return {}
        idx = jax_known_orientation_samples(k, batch, opts.num_hypotheses)
        return real(idx, recon, view_ids, opts, **kw)

    monkeypatch.setattr(thy, "localize_views_known_orientation_batch",
                        localize)


def _positions(rec, views):
    return np.stack([rec.views[v].camera.position for v in views])


def _aligned_error(est, gt):
    s, R, t = align_point_clouds(est, gt)
    return np.linalg.norm(s * est @ R.T + t - gt, axis=1)


def test_hybrid_reconstruction_matches_jax(jax_samples):
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = cases.reconstructions(sc)
    jg, tg = cases.graphs(cases.graph_edges(sc))
    js = jhy.hybrid_reconstruction(jrec, jg, jhy.HybridOptions())
    ts = thy.hybrid_reconstruction(trec, tg, thy.HybridOptions(), **CPU)
    assert ts == js
    assert ts["success"] and ts["num_estimated_views"] == 8
    assert sorted(trec.estimated_tracks()) == sorted(jrec.estimated_tracks())
    views = sorted(jrec.estimated_views())
    assert sorted(trec.estimated_views()) == views
    tp, jp = _positions(trec, views), _positions(jrec, views)
    scale = np.linalg.norm(jp - jp.mean(0), axis=1).max()
    assert np.abs(tp - jp).max() < 1e-6 * scale
    for est in (tp, jp):
        assert np.median(_aligned_error(est, sc.extrinsics[views, :3])) \
            < 0.08


@pytest.mark.parametrize("kind", ["GLOBAL", "HYBRID"])
def test_builder_global_and_hybrid_reconstruct(kind):
    sc = cases.scene(np.random.default_rng(42))
    opts = trb.ReconstructionBuilderOptions() if kind == "GLOBAL" else \
        trb.ReconstructionBuilderOptions(reconstruction_estimator_type=kind)
    assert opts.reconstruction_estimator_type == kind
    models = _port_builder(sc, opts,
                           dtype=torch.float64).build_reconstruction()
    assert len(models) == 1
    m = models[0]
    views = sorted(m.estimated_views())
    assert len(views) == 8 and len(m.estimated_tracks()) > 100
    gt = np.stack([sc.extrinsics[int(m.views[v].name[3:-4]), :3]
                   for v in views])
    assert np.median(_aligned_error(_positions(m, views), gt)) < 0.08


@pytest.mark.parametrize("kind,name", [("GLOBAL", "global_reconstruction"),
                                       ("HYBRID", "hybrid_reconstruction")])
def test_builder_hands_dtype_and_device_on(kind, name, monkeypatch):
    seen = {}

    def estimator(recon, graph, opts, **kw):
        seen.update(kw)
        return {"success": False}
    monkeypatch.setattr(trb, name, estimator)
    sc = cases.scene(np.random.default_rng(42))
    _port_builder(sc, trb.ReconstructionBuilderOptions(
        reconstruction_estimator_type=kind),
        dtype=torch.float64).build_reconstruction()
    assert seen == {"dtype": torch.float64, "device": torch.device("cpu")}
