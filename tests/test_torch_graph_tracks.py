"""The port's graph algorithms, view graph and track builder against the
JAX package's on the same inputs: math/graph.py (UnionFind, connected
components, largest component, Kruskal, triplets: equal results),
sfm/view_graph.py (ViewGraph and swap_two_view_info: payloads to 1e-12
in float64) and sfm/track_builder.py (the same tracks with the same ids
and observations, inconsistent and too-short groups dropped alike; the
JAX package labels components natively where libhost_ops.so is built,
the port with UnionFind)."""
import dataclasses

import numpy as np
import pytest

from theiasfm_tpu.math import graph as jgraph
from theiasfm_tpu.sfm import view_graph as jvg
from theiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from theiasfm_tpu.sfm.track_builder import TrackBuilder as JTB
from theiasfm_tpu_torch import convert
from theiasfm_tpu_torch.math import graph as tgraph
from theiasfm_tpu_torch.sfm import view_graph as tvg
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction as TRecon
from theiasfm_tpu_torch.sfm.track_builder import TrackBuilder as TTB

import torch_sfm_cases as cases
from torch_sfm_cases import one_torch_thread  # noqa: F401


def _edges(rng, n, m):
    e = rng.integers(0, n, size=(m, 2))
    return [(int(a), int(b)) for a, b in e if a != b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_algorithms_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 40
    edges = _edges(rng, n, 45)
    np.testing.assert_array_equal(tgraph.connected_components(n, edges),
                                  jgraph.connected_components(n, edges))
    nodes = list(range(0, 2 * n, 2))
    named = [(2 * a, 2 * b) for a, b in edges]
    assert (tgraph.largest_connected_component(nodes, named) ==
            jgraph.largest_connected_component(nodes, named))
    e = np.asarray(edges)
    w = rng.random(len(e))
    assert (tgraph.minimum_spanning_tree(n, e, w) ==
            jgraph.minimum_spanning_tree(n, e, w))
    dense = _edges(rng, 12, 60)
    assert tgraph.extract_triplets(dense) == jgraph.extract_triplets(dense)
    tu, ju = tgraph.UnionFind(n), jgraph.UnionFind(n)
    for a, b in edges:
        assert tu.union(a, b) == ju.union(a, b)
    assert tu.components() == ju.components()


def _info(rng, mod):
    return mod.TwoViewInfo(
        focal_length_1=float(rng.uniform(500, 900)),
        focal_length_2=float(rng.uniform(500, 900)),
        position_2=rng.normal(size=3), rotation_2=rng.normal(size=3) * 0.4,
        num_verified_matches=int(rng.integers(30, 300)),
        num_homography_inliers=int(rng.integers(0, 30)),
        visibility_score=int(rng.integers(0, 900)))


def _same_info(a, b, tol=1e-12):
    for f in dataclasses.fields(a):
        np.testing.assert_allclose(getattr(b, f.name), getattr(a, f.name),
                                   rtol=0, atol=tol, err_msg=f.name)


def test_swap_two_view_info_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        j = _info(rng, jvg)
        t = tvg.TwoViewInfo(**dataclasses.asdict(j))
        _same_info(jvg.swap_two_view_info(j), tvg.swap_two_view_info(t))
    # the small-angle branch
    j = jvg.TwoViewInfo(rotation_2=np.full(3, 1e-8), position_2=np.ones(3))
    t = tvg.TwoViewInfo(**dataclasses.asdict(j))
    _same_info(jvg.swap_two_view_info(j), tvg.swap_two_view_info(t))


def test_view_graph_matches_jax():
    """The same edge edits in both packages (reversed ids swap the
    payload) leave the same views, edges and payloads; the largest
    component is kept alike; convert.view_graph_from_state copies a JAX
    graph."""
    rng = np.random.default_rng(4)
    jg, tg = jvg.ViewGraph(), tvg.ViewGraph()
    for a, b in _edges(rng, 14, 18) + [(20, 21), (22, 20)]:
        j = _info(rng, jvg)
        jg.add_edge(a, b, j)
        tg.add_edge(a, b, tvg.TwoViewInfo(**dataclasses.asdict(j)))
    assert jg.remove_edge(*next(iter(jg.edges()))) == \
        tg.remove_edge(*next(iter(tg.edges())))
    assert jg.remove_view(3) == tg.remove_view(3)
    assert jg.remove_disconnected_views() == tg.remove_disconnected_views()
    for g in (jg, tg):
        assert not g.has_edge(7, 7)
    assert (tg.num_views(), tg.num_edges(), tg.view_ids()) == \
        (jg.num_views(), jg.num_edges(), jg.view_ids())
    assert sorted(tg.edges()) == sorted(jg.edges())
    for (a, b), j in jg.edges().items():
        _same_info(j, tg.edge(a, b))
        assert tg.neighbors(a) == jg.neighbors(a)
    copied = convert.view_graph_from_state(
        {k: dataclasses.asdict(v) for k, v in jg.edges().items()})
    assert sorted(copied.edges()) == sorted(jg.edges())
    for k, j in jg.edges().items():
        _same_info(j, copied.edge(*k), tol=0)


def _tracks(rec):
    return {t: sorted((v, tuple(rec.views[v].features[t]))
                      for v in tr.views) for t, tr in rec.tracks.items()}


def test_track_builder_matches_jax():
    """The scene's pairwise correspondences plus an inconsistent chain
    (a track that sees view 0 twice) and a too-short group: the same
    tracks, ids and observations in both packages."""
    sc = cases.scene(np.random.default_rng(5), n_views=5, n_pts=60)
    recs = []
    for Recon, TB in ((JRecon, JTB), (TRecon, TTB)):
        rec = Recon()
        for v in range(sc.n_views):
            rec.add_view(f"img{v}.jpg")
        tb = TB(min_track_length=3, max_track_length=4)
        for v1 in range(sc.n_views):
            for v2 in range(v1 + 1, sc.n_views):
                for row in cases.correspondences(sc, v1, v2):
                    tb.add_feature_correspondence(v1, row[:2], v2,
                                                  row[2:])
        # inconsistent: two features of view 0 joined through view 1
        tb.add_feature_correspondence(0, (1.5, 2.5), 1, (3.5, 4.5))
        tb.add_feature_correspondence(1, (3.5, 4.5), 0, (5.5, 6.5))
        tb.add_feature_correspondence(0, (5.5, 6.5), 2, (7.5, 8.5))
        # too short for min_track_length=3
        tb.add_feature_correspondence(3, (9.5, 9.5), 4, (10.5, 10.5))
        recs.append((tb.build_tracks(rec), rec))
    (jn, jrec), (tn, trec) = recs
    assert tn == jn and tn > 20
    assert _tracks(trec) == _tracks(jrec)
    assert all(2 < len(tr.views) <= 4 for tr in trec.tracks.values())
