"""The generator: the published counts exactly, the same inputs per seed."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.bal import generator
from benchmark import registry

BENCH = registry.Benchmark()


def _cfg(name, **counts):
    cfg = BENCH.config(name)
    cfg.update(counts)
    return cfg


def _scene(seed, cells=("bal_venice1778", "shared_calib"), **counts):
    cfg = _cfg(cells[0], **counts)
    return generator.make_scene(cfg, BENCH.traffic(cells[1]), seed, "cpu")


@pytest.mark.parametrize("name", ["bal_venice1778", "bal_final13682"])
def test_track_lengths_give_published_counts(name):
    cfg = BENCH.config(name)
    pub = cfg["published"]
    assert (cfg["cameras"], cfg["points"], cfg["observations"]) == (
        pub["cameras"], pub["points"], pub["observations"])
    g = generator.generator("cpu", 2**31 + 77, "scene")
    L = generator.track_lengths(g, pub["points"], pub["observations"])
    assert L.shape == (pub["points"],)
    assert int(L.sum()) == pub["observations"]
    assert int(L.min()) >= 2
    mean = pub["observations"] / pub["points"]
    assert abs(float(L.double().mean()) - mean) < 1e-9


def test_venice_scene_at_published_counts():
    cfg = BENCH.config("bal_venice1778")
    sc = generator.make_scene(cfg, BENCH.traffic("shared_calib"),
                              3_000_000_017, "cpu")
    pub = cfg["published"]
    assert sc.counts == (pub["cameras"], pub["points"], pub["observations"])
    assert sc.intrinsics.shape == (1, 10)
    assert bool(sc.obs_mask.all())
    assert bool((sc.obs_pt[1:] >= sc.obs_pt[:-1]).all())


def test_tracks_see_distinct_cameras_sorted_by_point():
    sc = _scene(5, cameras=40, points=3000, observations=15100)
    assert sc.counts == (40, 3000, 15100)
    key = sc.obs_pt * 40 + sc.obs_cam
    assert bool((key[1:] > key[:-1]).all())
    assert int(torch.bincount(sc.obs_pt).min()) >= 2


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_inputs(seed):
    a = _scene(seed, cameras=30, points=500, observations=2600)
    b = _scene(seed, cameras=30, points=500, observations=2600)
    for f in ("extrinsics", "points", "intrinsics", "obs_cam", "obs_group",
              "obs_pt", "obs_pix", "obs_mask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    t = BENCH.traffic("shared_calib")
    for k in (0, 3):
        (e1, p1), (e2, p2) = (generator.start(a, t, seed, k),
                              generator.start(b, t, seed, k))
        assert torch.equal(e1, e2) and torch.equal(p1, p2)
    assert not torch.equal(generator.start(a, t, seed, 0)[1],
                           generator.start(a, t, seed, 1)[1])


def test_other_seed_other_inputs():
    a = _scene(1, cameras=30, points=500, observations=2600)
    b = _scene(2, cameras=30, points=500, observations=2600)
    assert not torch.equal(a.obs_pix, b.obs_pix)


@pytest.mark.parametrize("groups,n", [("shared", 1), ("per_camera", 30)])
def test_intrinsics_groups(groups, n):
    cfg = _cfg("bal_venice1778", cameras=30, points=500, observations=2600)
    traffic = dict(BENCH.traffic("shared_calib"), intrinsics_groups=groups)
    sc = generator.make_scene(cfg, traffic, 9, "cpu")
    assert sc.intrinsics.shape == (n, 10)
    assert torch.equal(sc.obs_group, sc.obs_cam % n)


def test_outliers_move_the_share_asked_for():
    cfg = _cfg("bal_venice1778", cameras=30, points=4000, observations=20000)
    plain = BENCH.traffic("shared_calib")
    dirty = dict(plain, outliers={"share": 0.1, "pixels": 50.0})
    a = generator.make_scene(cfg, plain, 4, "cpu")
    b = generator.make_scene(cfg, dirty, 4, "cpu")
    moved = (a.obs_pix - b.obs_pix).abs().amax(dim=1)
    assert torch.equal(a.obs_cam, b.obs_cam)
    assert abs(float((moved > 0).double().mean()) - 0.1) < 0.01
    assert float(moved.max()) <= 50.0


def test_start_noise_has_the_stated_size():
    sc = _scene(4, cameras=30, points=20000, observations=60000)
    t = BENCH.traffic("shared_calib")
    _, pts = generator.start(sc, t, 4, 0)
    sigma = float((pts.double() - sc.points).std())
    want = sum(s * s for s in t["start_noise"]["point"]) ** 0.5
    assert abs(sigma - want) < 0.02 * want


def test_pixels_are_the_truth_plus_noise():
    from benchmark.bal import camera
    sc = _scene(6, cameras=30, points=4000, observations=20000)
    uv, _ = camera.project(sc.extrinsics[sc.obs_cam],
                           sc.intrinsics.double()[sc.obs_group],
                           sc.points[sc.obs_pt])
    noise = (sc.obs_pix.double() - uv).std()
    assert abs(float(noise) - 0.5) < 0.02
    cfg = json.loads((registry.ROOT / "benchmark" / "configs" /
                      "bal_venice1778.json").read_text())
    assert cfg["scene"]["pixel_noise"] == 0.5
