"""The port's io package (theiasfm_tpu_torch/io) against the JAX
package's (theiasfm_tpu/io), in both directions, on synthetic
reconstructions built in both packages from one seed in the pattern of
tests/test_io.py::make_recon (5 views, 30 tracks).

Each format's writers write the same reconstruction in both packages,
and each package's reader reads the other's file. The deterministic
formats are held byte for byte: the Theia .bin, the calibration JSON,
PLY, the SIFT key files (text and binary) and the feature files; the npz
snapshot array by array, exactly (its zip container may differ). The
formats whose writer or reader computes a rotation (bundler, NVM,
COLMAP, PMVS; Strecha and 1DSfM read) agree within 1e-12 relative: JAX
converts them with jax.numpy under the suite's x64 mode, the port with
its own math/rotation in float64."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import theiasfm_tpu.io as jio
import theiasfm_tpu_torch.io as tio
from theiasfm_tpu.camera import models as jcam
from theiasfm_tpu.sfm.reconstruction import (
    CameraIntrinsicsPrior as JPrior, Reconstruction as JRecon)
from theiasfm_tpu.camera.models import CameraModelType as JModel
from theiasfm_tpu_torch.camera import models as tcam
from theiasfm_tpu_torch.convert import (intrinsics_prior_from_state,
                                        reconstruction_from_state)
from theiasfm_tpu_torch.io import theia_format as ttf
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction as TRecon

REPO = Path(__file__).resolve().parents[1]
REL = 1e-12


def _state(recon):
    return {"views": {v: dataclasses.asdict(x)
                      for v, x in recon.views.items()},
            "tracks": {t: dataclasses.asdict(x)
                       for t, x in recon.tracks.items()},
            "view_groups": dict(recon.view_groups),
            "next_view_id": recon._next_view_id,
            "next_track_id": recon._next_track_id,
            "next_group_id": recon._next_group_id}


def make_recons(seed=0, n_views=5, n_tracks=30):
    """tests/test_io.py::make_recon widened: views 0-2 share intrinsics
    group 0 (and so one intrinsics vector), the last is not estimated,
    view 3 is radial-tangential with a full prior, some tracks are not
    estimated. (JAX Reconstruction, the port's Reconstruction built from
    its state)."""
    rng = np.random.default_rng(seed)
    r = JRecon()
    vids = [r.add_view(f"im{i}.jpg", group=0 if i < 3 else None)
            for i in range(n_views)]
    for i, v in enumerate(vids):
        view = r.views[v]
        view.is_estimated = i < n_views - 1
        view.camera.extrinsics = rng.normal(size=6)
        k = 0 if i < 3 else i
        view.camera.intrinsics[0] = 500.0 + 10 * k
        view.camera.intrinsics[3:5] = [320 + k, 240 - k]
        view.camera.intrinsics[5:7] = [1e-3 * k, -2e-4]
        view.camera.image_width = 640
        view.camera.image_height = 480
    cam = r.views[vids[3]].camera
    cam.model_type = JModel.PINHOLE_RADIAL_TANGENTIAL
    cam.intrinsics[7:10] = rng.normal(scale=1e-4, size=3)
    r.views[vids[3]].prior = JPrior(
        image_width=640, image_height=480, focal_length=510.0,
        principal_point=(321.0, 239.0), aspect_ratio=1.0, skew=0.0,
        radial_distortion=(0.01, -0.002, 0.0, 0.0),
        tangential_distortion=(1e-4, -2e-4),
        position=rng.normal(size=3), orientation=rng.normal(size=3),
        camera_intrinsics_model_type=JModel.PINHOLE_RADIAL_TANGENTIAL)
    r.views[vids[4]].prior = JPrior(image_width=640, image_height=480,
                                    focal_length=520.0)
    for i in range(n_tracks):
        t = r.add_track()
        tr = r.tracks[t]
        tr.is_estimated = i % 7 != 3
        tr.point = np.append(rng.normal(size=3) + [0, 0, 5.0], 1.0)
        tr.color = rng.integers(0, 255, 3).astype(np.uint8)
        for v in rng.choice(vids, size=3, replace=False):
            r.add_observation(int(v), t, rng.uniform(0, 480, 2))
    return r, reconstruction_from_state(_state(r))


def assert_recons_agree(a, b, rtol=0.0):
    """Two reconstructions (either package's) hold the same views,
    cameras, priors, groups, tracks and observations: exactly, or
    within rtol where the values went through a rotation."""
    def close(x, y):
        x, y = np.asarray(x, float), np.asarray(y, float)
        if rtol:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol)
        else:
            np.testing.assert_array_equal(x, y)

    assert sorted(a.views) == sorted(b.views)
    assert sorted(a.tracks) == sorted(b.tracks)
    for v in a.views:
        va, vb = a.views[v], b.views[v]
        assert va.name == vb.name and va.is_estimated == vb.is_estimated
        ca, cb = va.camera, vb.camera
        assert int(ca.model_type) == int(cb.model_type)
        assert (ca.image_width, ca.image_height) == (cb.image_width,
                                                     cb.image_height)
        close(ca.extrinsics, cb.extrinsics)
        close(ca.intrinsics, cb.intrinsics)
        pa, pb = dataclasses.asdict(va.prior), dataclasses.asdict(vb.prior)
        assert pa.keys() == pb.keys()
        for k in pa:
            if pa[k] is None or pb[k] is None:
                assert pa[k] is None and pb[k] is None, k
            elif k == "camera_intrinsics_model_type":
                assert int(pa[k]) == int(pb[k])
            else:
                close(pa[k], pb[k])
        assert sorted(va.features) == sorted(vb.features)
        for t in va.features:
            close(va.features[t], vb.features[t])
    assert a.view_groups == b.view_groups
    for t in a.tracks:
        ta, tb = a.tracks[t], b.tracks[t]
        assert ta.is_estimated == tb.is_estimated
        assert set(ta.views) == set(tb.views)
        close(ta.point, tb.point)
        np.testing.assert_array_equal(ta.color, tb.color)


def assert_text_agrees(pa, pb, rtol=REL):
    """Two text files with the same tokens: numbers within rtol, every
    other token equal."""
    ta = Path(pa).read_text().split()
    tb = Path(pb).read_text().split()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            assert x == y
            continue
        assert abs(fx - fy) <= rtol * max(1.0, abs(fx), abs(fy)), (x, y)


def _npz_equal(pa, pb):
    za, zb = np.load(pa), np.load(pb)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _features(seed=0, n=17, d=128):
    rng = np.random.default_rng(seed)
    kps = np.concatenate([rng.uniform(0, 500, (n, 2)),
                          rng.uniform(1, 8, (n, 1)),
                          rng.uniform(-3, 3, (n, 1))], 1)
    desc = rng.uniform(0, 0.3, (n, d)).astype(np.float32)
    return kps, desc


def _priors():
    """The same calibration priors in both packages."""
    rng = np.random.default_rng(3)
    fields = {
        "a.jpg": dict(image_width=640, image_height=480,
                      focal_length=600.5, principal_point=(320.0, 241.5)),
        "b.jpg": dict(image_width=1024, image_height=768, aspect_ratio=1.01,
                      skew=0.0, radial_distortion=(0.1, -0.01, 0.0, 0.0),
                      tangential_distortion=(1e-3, 2e-3),
                      position=rng.normal(size=3),
                      orientation=rng.normal(size=3),
                      camera_intrinsics_model_type=int(
                          JModel.PINHOLE_RADIAL_TANGENTIAL)),
    }
    jp = {}
    for name, f in fields.items():
        f = dict(f)
        if "camera_intrinsics_model_type" in f:
            f["camera_intrinsics_model_type"] = JModel(
                f["camera_intrinsics_model_type"])
        jp[name] = JPrior(**f)
    tp = {n: intrinsics_prior_from_state(dataclasses.asdict(p))
          for n, p in jp.items()}
    return jp, tp


def _assert_priors_agree(a, b):
    assert a.keys() == b.keys()
    for n in a:
        da, db = dataclasses.asdict(a[n]), dataclasses.asdict(b[n])
        for k in da:
            if da[k] is None or db[k] is None:
                assert da[k] is None and db[k] is None, (n, k)
            elif k == "camera_intrinsics_model_type":
                assert int(da[k]) == int(db[k])
            else:
                np.testing.assert_array_equal(np.asarray(da[k], float),
                                              np.asarray(db[k], float))


# Each format: how a package writes the shared inputs into `base`
# (returns the paths written), how a package reads them back, and how
# two packages' files and readings are held.

def _w_theia(io, inp, base):
    io.write_theia_reconstruction(base + ".bin", inp)
    return [base + ".bin"]


def _w_native(io, inp, base):
    io.write_reconstruction(inp, base + ".npz")
    return [base + ".npz"]


def _w_bundler(io, inp, base):
    io.write_bundler(inp, base + ".list.txt", base + ".out")
    return [base + ".list.txt", base + ".out"]


def _w_nvm(io, inp, base):
    io.write_nvm(inp, base + ".nvm")
    return [base + ".nvm"]


def _w_colmap(io, inp, base):
    io.write_colmap(inp, base)
    return [os.path.join(base, f) for f in
            ("cameras.txt", "images.txt", "points3D.txt")]


def _w_ply(io, inp, base):
    io.write_ply(inp, base + ".ply")
    return [base + ".ply"]


def _w_pmvs(io, inp, base):
    n = io.export_pmvs(inp, base)
    return [os.path.join(base, "txt", f"{i:08d}.txt") for i in range(n)] + [
        os.path.join(base, "pmvs_options.txt")]


def _w_calibration(io, inp, base):
    io.write_calibration(inp, base + ".json")
    return [base + ".json"]


def _w_sift_text(io, inp, base):
    io.write_sift_text(base + ".key", *inp)
    return [base + ".key"]


def _w_sift_binary(io, inp, base):
    io.write_sift_binary(base + ".bkey", *inp)
    return [base + ".bkey"]


def _w_features(io, inp, base):
    io.write_keypoints_and_descriptors(base + ".features", *inp)
    return [base + ".features"]


FORMATS = {
    # name: (writer, reader(io, paths) or None, inputs, file check, rtol)
    "theia": (_w_theia, lambda io, p: io.read_theia_reconstruction(p[0]),
              "recon", "bytes", 0.0),
    "native": (_w_native, lambda io, p: io.read_reconstruction(p[0]),
               "recon", "npz", 0.0),
    "bundler": (_w_bundler, lambda io, p: io.read_bundler(p[0], p[1]),
                "recon", "text", REL),
    "nvm": (_w_nvm, lambda io, p: io.read_nvm(p[0]), "recon", "text", REL),
    "colmap": (_w_colmap, None, "recon", "text", REL),
    "ply": (_w_ply, None, "recon", "bytes", 0.0),
    "pmvs": (_w_pmvs, None, "recon", "text", REL),
    "calibration": (_w_calibration,
                    lambda io, p: io.read_calibration(p[0]), "priors",
                    "bytes", 0.0),
    "sift_text": (_w_sift_text, lambda io, p: io.read_sift_text(p[0]),
                  "features", "bytes", 0.0),
    "sift_binary": (_w_sift_binary,
                    lambda io, p: io.read_sift_binary(p[0]), "features",
                    "bytes", 0.0),
    "features": (_w_features,
                 lambda io, p: io.read_keypoints_and_descriptors(p[0]),
                 "features", "bytes", 0.0),
}


def _inputs(kind):
    if kind == "recon":
        return make_recons()
    if kind == "priors":
        return _priors()
    f = _features()
    return f, f


def _readings_agree(kind, a, b, rtol):
    if kind == "recon":
        assert_recons_agree(a, b, rtol)
    elif kind == "priors":
        _assert_priors_agree(a, b)
    else:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _files_agree(check, pa, pb):
    for fa, fb in zip(pa, pb):
        if check == "bytes":
            assert Path(fa).read_bytes() == Path(fb).read_bytes(), fa
        elif check == "npz":
            _npz_equal(fa, fb)
        else:
            assert_text_agrees(fa, fb)


@pytest.mark.parametrize("direction", ["jax_writes_port_reads",
                                       "port_writes_jax_reads"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_format_across_packages(fmt, direction, tmp_path):
    """The writer of one package, the reader of the other: the two
    packages' files agree (bytes, npz arrays, or numbers within 1e-12),
    and the reader of each package reads the writer's file to the same
    thing as the writer's own package does."""
    write, read, kind, check, rtol = FORMATS[fmt]
    j_in, t_in = _inputs(kind)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = write(jio, j_in, str(tmp_path / "j" / fmt))
    pt = write(tio, t_in, str(tmp_path / "t" / fmt))
    src, dst = (pj, (jio, tio)) if direction.startswith("jax") else \
        (pt, (tio, jio))
    _files_agree(check, *(pj, pt) if direction.startswith("jax")
                 else (pt, pj))
    if read is None:
        return
    own, other = read(dst[0], src), read(dst[1], src)
    _readings_agree(kind, own, other, rtol)
    if fmt == "theia":
        # the lossless format reads back the reconstruction written
        assert_recons_agree(other, t_in if dst[1] is tio else j_in)


def test_npz_reader_decompresses_each_member_once(tmp_path, monkeypatch):
    """The port's read_reconstruction reads each npz member once (JAX's
    decompresses a member on every index, so its loops over tracks and
    observations are quadratic) and reads what JAX's reads."""
    j, t = make_recons(seed=2, n_tracks=40)
    path = str(tmp_path / "r.npz")
    tio.write_reconstruction(t, path)
    reads = []
    real = np.lib.npyio.NpzFile.__getitem__

    def counted(self, key):
        reads.append(key)
        return real(self, key)
    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", counted)
    port = tio.read_reconstruction(path)
    assert sorted(reads) == sorted(set(reads)) and len(reads) == 14
    monkeypatch.undo()
    assert_recons_agree(port, jio.read_reconstruction(path))


def test_native_reader_equals_python_and_jax(tmp_path):
    """A JAX-written .bin: the port's C++ reader (built from
    native/theia_io.cc at first use), its Python parser and JAX's reader
    read the same reconstruction."""
    j, _ = make_recons(seed=4)
    path = str(tmp_path / "r.bin")
    jio.write_theia_reconstruction(path, j)
    native = ttf.read_theia_reconstruction_native(path)
    assert native is not None
    python = tio.read_theia_reconstruction(path, prefer_native=False)
    assert_recons_agree(native, python)
    assert_recons_agree(python, jio.read_theia_reconstruction(
        path, prefer_native=False))
    assert_recons_agree(native, j)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A native build that fails raises with the compiler's output; it
    does not fall back to the Python parser."""
    from theiasfm_tpu_torch.utils import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such",))
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fno-such"):
            tio.read_theia_reconstruction(str(tmp_path / "none.bin"))
    finally:
        native.get_lib.cache_clear()


def test_native_graph_routines_match_jax():
    """The port's bindings of host_ops.cc give JAX's bindings' results."""
    from theiasfm_tpu.utils import native as jn
    from theiasfm_tpu_torch.utils import native as tn
    rng = np.random.default_rng(2)
    e = rng.integers(0, 40, (120, 2))
    w = rng.uniform(0, 1, 120)
    np.testing.assert_array_equal(
        tn.connected_components_native(40, e[:, 0], e[:, 1]),
        jn.connected_components_native(40, e[:, 0], e[:, 1]))
    np.testing.assert_array_equal(
        tn.mfas_order_native(40, e[:, 0], e[:, 1], w),
        jn.mfas_order_native(40, e[:, 0], e[:, 1], w))
    np.testing.assert_array_equal(tn.kruskal_mst_native(40, e, w),
                                  jn.kruskal_mst_native(40, e, w))


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_read_strecha_dataset(tmp_path):
    """A small Strecha directory (<image>.camera: K, a zero line, R
    camera->world, position, size) read by both packages."""
    rng = np.random.default_rng(5)
    for i in range(4):
        K = np.array([[2759.48 + i, 0.5, 1520.69], [0, 2764.16, 1006.81],
                      [0, 0, 1]])
        vals = [*K.ravel(), 0, 0, 0, *_rotation(rng).ravel(),
                *rng.normal(size=3), 3072, 2048]
        (tmp_path / f"{i:04d}.png.camera").write_text(
            "\n".join(" ".join(repr(float(v)) for v in vals[k:k + 3])
                      for k in range(0, 24, 3)) + "\n3072 2048\n")
    a = tio.read_strecha_dataset(str(tmp_path))
    b = jio.read_strecha_dataset(str(tmp_path))
    assert a.num_views() == 4
    assert_recons_agree(a, b, REL)


def _write_1dsfm(d, rng, n_views=5, n_keys=12):
    names = [f"images/v{i}.jpg" for i in range(n_views)]
    (d / "list.txt").write_text("\n".join(
        f"{n} 0 {700.0 + i}" if i % 2 == 0 else n
        for i, n in enumerate(names)) + "\n")
    (d / "cc.txt").write_text(" ".join(str(i) for i in range(n_views - 1)))
    lines = []
    for v in range(n_views):
        lines.append(f"#index = {v}, name = v{v}.jpg keys = {n_keys}, "
                     f"px = {320.0 + v}, py = 240.0, focal = 700.0")
        for k in range(n_keys):
            x, y = rng.uniform(-300, 300, 2)
            c = rng.integers(0, 255, 3)
            lines.append(f"{k} {x} {y} 0 0 {c[0]} {c[1]} {c[2]}")
    (d / "coords.txt").write_text("\n".join(lines) + "\n")
    tracks = []
    for t in range(8):
        vs = rng.choice(n_views, 3, replace=False)
        tracks.append("3 " + " ".join(f"{v} {rng.integers(0, n_keys)}"
                                       for v in vs))
    (d / "tracks.txt").write_text(f"{len(tracks)}\n" + "\n".join(tracks))
    egs = []
    for v1, v2 in [(0, 1), (2, 1), (1, 3), (0, 2), (3, 4)]:
        R, t = _rotation(rng), rng.normal(size=3)
        egs.append(" ".join(map(str, [v1, v2, *R.ravel(), *t])))
    (d / "EGs.txt").write_text("\n".join(egs) + "\n")


def test_read_1dsfm(tmp_path):
    """A small 1DSfM directory (list, cc, coords, tracks, EGs; one view
    outside the component, one edge given as (2, 1)) read by both
    packages: the same views, priors, tracks and view-graph edges."""
    _write_1dsfm(tmp_path, np.random.default_rng(6))
    ta, ga = tio.read_1dsfm(str(tmp_path))
    tb, gb = jio.read_1dsfm(str(tmp_path))
    assert ta.num_views() == 4 and ga.num_edges() == 4
    assert_recons_agree(ta, tb)
    ea, eb = ga.edges(), gb.edges()
    assert sorted(ea) == sorted(eb)
    for k in ea:
        a, b = dataclasses.asdict(ea[k]), dataclasses.asdict(eb[k])
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_allclose(np.asarray(a[f], float),
                                       np.asarray(b[f], float),
                                       rtol=REL, atol=REL, err_msg=f)


def test_populate_image_sizes(tmp_path):
    """tests/test_util_extras.py's case in both packages."""
    from PIL import Image
    Image.new("RGB", (64, 48)).save(tmp_path / "img0.png")
    for io, Recon in ((tio, TRecon), (jio, JRecon)):
        recon = Recon()
        v = recon.add_view("img0.png")
        assert io.populate_image_sizes(recon, str(tmp_path))
        cam = recon.view(v).camera
        assert (cam.image_width, cam.image_height) == (64, 48)
        assert cam.intrinsics[3] == 32.0 and cam.intrinsics[4] == 24.0
        recon.add_view("missing.png")
        assert not io.populate_image_sizes(recon, str(tmp_path))
        assert not io.populate_image_sizes(recon, str(tmp_path / "nodir"))


def test_exports_match_jax():
    """The io package exports JAX's names; camera and utils the three
    names the port lacked."""
    import theiasfm_tpu.camera as jc
    import theiasfm_tpu.utils as ju
    import theiasfm_tpu_torch.camera as tc
    import theiasfm_tpu_torch.utils as tu

    def public(m):
        return {n for n in dir(m) if not n.startswith("_") and
                not isinstance(getattr(m, n), type(sys))}
    assert public(jio) <= public(tio)
    assert {"default_intrinsics", "project_batch"} <= public(tc)
    assert "total_dispatches" in public(tu)
    assert public(ju) <= public(tu)


def test_default_intrinsics_and_project_batch():
    """default_intrinsics (float64 by default, on the device asked for)
    and project_batch against JAX's under x64."""
    import jax.numpy as jnp
    p = tcam.default_intrinsics(600.0, 320.0, 240.0, aspect=1.1,
                                device="cpu")
    assert p.dtype == torch.float64 and p.device.type == "cpu"
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jcam.default_intrinsics(600.0, 320.0, 240.0,
                                                      aspect=1.1)))
    assert tcam.default_intrinsics(device="cpu",
                                   dtype=torch.float32).dtype == \
        torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcam.default_intrinsics()
    rng = np.random.default_rng(7)
    intr = np.stack([np.asarray(jcam.default_intrinsics(600.0, 320.0,
                                                        240.0))] * 7)
    intr[:, 5:7] = [0.01, 0.001]
    extr = np.concatenate([rng.normal(size=(7, 3)),
                           0.2 * rng.normal(size=(7, 3))], -1)
    pts = rng.normal(size=(7, 3)) + [0, 0, 5.0]
    model = JModel.PINHOLE
    pj, dj = jcam.project_batch(model, jnp.asarray(extr), jnp.asarray(intr),
                                jnp.asarray(pts))
    pt, dt = tcam.project_batch(tcam.CameraModelType.PINHOLE,
                                *map(torch.from_numpy, (extr, intr, pts)))
    assert pt.shape == (7, 2) and dt.shape == (7,)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12)


def test_total_dispatches_matches_jax():
    from theiasfm_tpu.utils import dispatch as jd
    from theiasfm_tpu_torch.utils import dispatch as td
    before = td.dispatch_counts()
    try:
        for m in (jd, td):
            m.reset_dispatch_counts()
            m.count_dispatch("a", 3)
            m.count_dispatch("b")
        assert td.total_dispatches() == jd.total_dispatches() == 4
    finally:
        td.reset_dispatch_counts()
        for k, n in before.items():
            td.count_dispatch(k, n)


def test_io_imports_without_pil_or_jax():
    """Importing theiasfm_tpu_torch.io (and the CLIs) imports no PIL,
    JAX or JAX package, and builds nothing."""
    code = textwrap.dedent("""
        import sys
        for name in ("PIL", "jax", "jaxlib", "theiasfm_tpu"):
            sys.modules[name] = None
        import theiasfm_tpu_torch.io as io
        import theiasfm_tpu_torch.apps.build_reconstruction
        import theiasfm_tpu_torch.apps.convert_reconstruction
        from theiasfm_tpu_torch.utils import native
        assert native.get_lib.cache_info().currsize == 0
        assert callable(io.read_theia_reconstruction)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
