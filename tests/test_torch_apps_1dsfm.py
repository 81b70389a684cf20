"""The port's 1DSfM CLIs (theiasfm_tpu_torch/apps:
build_1dsfm_reconstruction, verify_1dsfm_input,
evaluate_relative_translation_optimization) against the JAX package's
on one dataset directory, on the CPU, and the dataset writer behind
them (chip_smoke.write_1dsfm) against both packages' read_1dsfm.

The dataset: bench_problem.build_city_scene(default_rng(0), 30 views,
4,000 points) (786 tracks, 30 edges) written by chip_smoke.write_1dsfm.
Tolerances: host float64 numbers within 1e-9 relative; the translation
refinement (float64 in both packages, the port on the CPU) within 1e-4
plus one printed unit; the global pipeline's float32 model within 1e-3
where a number went through the pipeline's float32 stages. The build
test stubs out the global BA (`_run_ba`) in both packages, as the
pipeline's 100 LM iterations cost some 20 s a package on the CPU here;
the whole pipeline is held to JAX's in tests/test_torch_global_pipeline.py."""
import numpy as np
import pytest

import chip_smoke as cs
import theiasfm_tpu.io as jio
import theiasfm_tpu_torch.io as tio
from theiasfm_tpu.sfm.pipeline import global_pipeline as jgp
from theiasfm_tpu_torch.bench_problem import build_city_scene
from theiasfm_tpu_torch.sfm.pipeline import global_pipeline as tgp
from torch_apps_cases import (DEVICE_REL, HOST_REL, assert_same_printout,
                              run_jax, run_port)
from torch_sfm_cases import one_torch_thread  # noqa: F401

CITY = (30, 4000)


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    d = tmp_path_factory.mktemp("city")
    recon, graph, extrs = build_city_scene(np.random.default_rng(0), *CITY)
    cs.write_1dsfm(d, recon, graph, extrs)
    return d, recon, graph, extrs


@pytest.mark.parametrize("package", ["port", "jax"])
def test_1dsfm_writer_round_trip(city, package):
    """read_1dsfm of either package gets back the city's views, tracks
    and observations bit for bit, its edges within 1e-9 (a rotation is
    computed on the way), the focal prior on every camera; the ground
    truth reads back within 1e-9."""
    d, recon, graph, extrs = city
    io_ = {"port": tio, "jax": jio}[package]
    r, g = io_.read_1dsfm(str(d))
    assert sorted(r.views) == sorted(recon.views)
    assert sorted(r.tracks) == sorted(recon.tracks) and len(r.tracks) > 700
    for v in recon.views:
        a, b = recon.views[v], r.views[v]
        assert a.name == b.name and list(a.features) == list(b.features)
        for t, xy in a.features.items():
            np.testing.assert_array_equal(b.features[t], xy)
        assert b.camera.intrinsics[0] == 800.0
        np.testing.assert_array_equal(b.camera.intrinsics[3:5], [640, 480])
    for t in recon.tracks:
        assert set(r.tracks[t].views) == set(recon.tracks[t].views)
    assert list(g.edges()) == list(graph.edges()) and len(g.edges()) >= 30
    for k, info in graph.edges().items():
        np.testing.assert_allclose(g.edges()[k].rotation_2,
                                   info.rotation_2, rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.edges()[k].position_2,
                                   info.position_2, rtol=0, atol=1e-9)
        assert g.edges()[k].focal_length_1 == 800.0
    gt = io_.read_bundler(str(d / "list.txt"), str(d / "gt_bundle.out"))
    for i, v in enumerate(sorted(gt.views)):
        np.testing.assert_allclose(gt.views[v].camera.extrinsics, extrs[i],
                                   rtol=0, atol=1e-9)


def test_build_1dsfm_reconstruction_matches_jax(city, tmp_path,
                                                monkeypatch):
    d = city[0]
    monkeypatch.setattr(tgp, "_run_ba", lambda *a, **k: None)
    monkeypatch.setattr(jgp, "_run_ba", lambda *a, **k: None)
    base = ["--1dsfm_dataset_directory", d]
    rc_j, out_j = run_jax("build_1dsfm_reconstruction", base + [
        "--output_reconstruction", tmp_path / "jax.npz"], monkeypatch)
    rc_p, out_p = run_port("build_1dsfm_reconstruction", base + [
        "--output_reconstruction", tmp_path / "port.npz", "--device",
        "cpu"])
    assert rc_j == rc_p == 0

    def lines(out):
        """The printout without the summary's stage seconds."""
        head, summary, tail = out.split("\n", 2)
        assert summary.startswith("{'success': True")
        return head + "\n" + summary.split(", 'timings'")[0] + "\n" + tail
    assert_same_printout(lines(out_p), lines(out_j), HOST_REL, subs=[
        (str(tmp_path / "port.npz"), "<out>"),
        (str(tmp_path / "jax.npz"), "<out>")])
    a = tio.read_reconstruction(str(tmp_path / "port.npz"))
    b = jio.read_reconstruction(str(tmp_path / "jax.npz"))
    assert a.estimated_views() == b.estimated_views()
    assert a.estimated_tracks() == b.estimated_tracks()
    assert len(a.estimated_views()) >= 25
    for v in a.estimated_views():
        np.testing.assert_allclose(a.views[v].camera.extrinsics,
                                   b.views[v].camera.extrinsics,
                                   rtol=1e-3, atol=1e-3)


def test_verify_1dsfm_input_matches_jax(city, monkeypatch):
    d = city[0]
    argv = ["--1dsfm_dataset_directory", d]
    rc_j, out_j = run_jax("verify_1dsfm_input", argv, monkeypatch)
    rc_p, out_p = run_port("verify_1dsfm_input", argv)
    assert rc_j == rc_p == 0
    assert_same_printout(out_p, out_j, HOST_REL)
    assert "views: 30 (gt poses: 30), edges: 30" in out_p


def test_evaluate_relative_translation_optimization_matches_jax(
        city, monkeypatch):
    d = city[0]
    argv = ["--1dsfm_dataset_directory", d,
            "--max_correspondences_per_pair", "48"]
    rc_j, out_j = run_jax("evaluate_relative_translation_optimization",
                          argv, monkeypatch)
    rc_p, out_p = run_port("evaluate_relative_translation_optimization",
                           argv + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    before, after = out_p.split("AFTER")
    jbefore, jafter = out_j.split("AFTER")
    assert_same_printout(before, jbefore, HOST_REL)
    assert_same_printout(after, jafter, DEVICE_REL, last_digit=True)
    assert "edges evaluated: 30" in out_p
