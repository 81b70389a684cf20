"""The whole incremental slice against the JAX package: both packages'
incremental_reconstruction on the synthetic scene of
tests/test_incremental_pipeline.py (8 views, 150 points, 0.3 px noise;
tests/torch_sfm_cases.py), from the same reconstruction and a view
graph of the true relative poses, in float64 on the CPU. The port's
localization rounds take the sample indices JAX draws from its key.

Both estimate all 8 views and the same tracks with the same launches
per step; camera positions agree to 1e-6 of the scene's scale (the
8-unit camera distance), and after a similarity alignment to the truth
(JAX's sfm/transformation) the median position error is under 1% of
that scale in both."""
import jax
import numpy as np
import pytest
import torch

from theiasfm_tpu.sfm.pipeline import (IncrementalOptions as JOptions,
                                       incremental_reconstruction as jincr)
from theiasfm_tpu.sfm.transformation import align_point_clouds
from theiasfm_tpu_torch.sfm.pipeline import incremental as tinc
from theiasfm_tpu_torch.sfm.pipeline import localize as tlo

import torch_sfm_cases as cases
from torch_sfm_cases import one_torch_thread  # noqa: F401


@pytest.fixture
def jax_samples(monkeypatch):
    """Make the port's incremental pipeline localize with the indices
    JAX's draws: the same key splits per round, the same per-view keys."""
    real = tinc.localize_views_batch
    state = {"key": jax.random.split(jax.random.PRNGKey(0))[0]}

    def localize(samples, recon, view_ids, opts, **kw):
        state["key"], k = jax.random.split(state["key"])
        batch = tlo.prepare_localize_batch(recon, view_ids, opts)
        if batch is None:
            return {}
        idx = cases.jax_localize_samples(k, batch, opts.num_hypotheses)
        return real(idx, recon, view_ids, opts, **kw)

    monkeypatch.setattr(tinc, "localize_views_batch", localize)


def _positions(rec, views):
    return np.stack([rec.views[v].camera.position for v in views])


def _aligned_error(est, gt):
    s, R, t = align_point_clouds(est, gt)
    return np.linalg.norm(s * est @ R.T + t - gt, axis=1)


def test_incremental_reconstruction_matches_jax(jax_samples):
    sc = cases.scene(np.random.default_rng(42))
    jrec, trec = cases.reconstructions(sc)
    jg, tg = cases.graphs(cases.graph_edges(sc))
    js = jincr(jrec, jg, JOptions())
    ts = tinc.incremental_reconstruction(trec, tg, tinc.IncrementalOptions(),
                                         dtype=torch.float64, device="cpu")
    assert ts["success"] and js["success"]
    assert ts["num_estimated_views"] == js["num_estimated_views"] == 8
    assert ts["num_estimated_tracks"] == js["num_estimated_tracks"] > 100
    steps = ("localize_batch", "triangulate_tracks", "bundle_adjust")
    assert {k: ts["device_dispatches"][k] for k in steps} == \
        {k: js["device_dispatches"][k] for k in steps}
    assert sorted(trec.estimated_tracks()) == sorted(jrec.estimated_tracks())
    views = sorted(jrec.estimated_views())
    assert sorted(trec.estimated_views()) == views
    tp, jp = _positions(trec, views), _positions(jrec, views)
    scale = np.linalg.norm(jp - jp.mean(0), axis=1).max()
    assert np.abs(tp - jp).max() < 1e-6 * scale
    gt = sc.extrinsics[views, :3]
    for est in (tp, jp):
        assert np.median(_aligned_error(est, gt)) < 0.08
