"""Reader and writer for TheiaSfM's cereal PortableBinary reconstruction
files (port of theiasfm_tpu/io/theia_format.py).

ref: src/theia/io/reconstruction_reader.cc:37-71 (the reference
deserializes with cereal::PortableBinaryInputArchive). This is a
from-scratch binary parser of that wire format built from the
serialize() declarations:
  Reconstruction (reconstruction.h:159-167): next_track_id,
    next_view_id, view_name_to_id, views, tracks, view->group map,
    group->views map
  View (view.h:92-94): name, is_estimated, Camera, prior, features
  Camera v0 (camera/camera.h:207-245): 13 doubles (6 extrinsics +
    7 pinhole intrinsics) + int32[2] image size
  Track (track.h:80-83): is_estimated, view_ids, Vector4d point,
    Matrix<uint8,3,1> color
  CameraIntrinsicsPrior v3/v4 (camera_intrinsics_prior.h:102-130)
  Eigen types (io/eigen_serializable.h:51-57): int32 rows, int32 cols,
    raw column-major scalar data.

Cereal conventions: leading endianness byte (PortableBinary), class
versions written as uint32 at the FIRST occurrence of each versioned
type per archive, strings/containers length-prefixed with uint64.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict

import numpy as np

from ..camera.models import MAX_INTRINSICS, CameraModelType
from ..sfm.reconstruction import (CameraIntrinsicsPrior, Reconstruction)


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.seen_versions: Dict[str, int] = {}

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError(f"truncated at {self.pos}")
        self.pos += n
        return b

    def u8(self):
        return self.raw(1)[0]

    def u32(self):
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self):
        return struct.unpack("<i", self.raw(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.raw(8))[0]

    def f64(self, n=1):
        return np.frombuffer(self.raw(8 * n), dtype="<f8").copy()

    def boolean(self):
        return self.u8() != 0

    def string(self) -> str:
        n = self.u64()
        return self.raw(n).decode("utf-8")

    def version(self, type_key: str) -> int:
        """Class version: uint32 on first occurrence of the type."""
        if type_key not in self.seen_versions:
            self.seen_versions[type_key] = self.u32()
        return self.seen_versions[type_key]

    def eigen(self, dtype="<f8"):
        rows = self.i32()
        cols = self.i32()
        item = np.dtype(dtype).itemsize
        m = np.frombuffer(self.raw(rows * cols * item), dtype=dtype)
        return m.reshape(cols, rows).T.copy()  # column-major on disk


def _read_prior(c: _Cursor, n: int):
    """Prior<N>: versioned type (per N), bool is_set + N doubles."""
    c.version(f"Prior<{n}>")
    is_set = c.boolean()
    value = c.f64(n)
    return is_set, value


def _read_intrinsics_prior(c: _Cursor) -> CameraIntrinsicsPrior:
    ver = c.version("CameraIntrinsicsPrior")
    p = CameraIntrinsicsPrior()
    pp_set, pp = False, np.zeros(2)
    pos_set = orient_set = False
    pos = orient = np.zeros(3)
    td_set, td = False, np.zeros(2)
    if ver >= 4:
        p.image_width = c.i32()
        p.image_height = c.i32()
        _model_name = c.string()
        focal_set, focal = _read_prior(c, 1)
        pp_set, pp = _read_prior(c, 2)
        ar_set, ar = _read_prior(c, 1)
        skew_set, skew = _read_prior(c, 1)
        rd_set, rd = _read_prior(c, 4)
        td_set, td = _read_prior(c, 2)
        pos_set, pos = _read_prior(c, 3)
        orient_set, orient = _read_prior(c, 3)
        _read_prior(c, 1); _read_prior(c, 1); _read_prior(c, 1)
    elif ver == 3:
        p.image_width = c.i32()
        p.image_height = c.i32()
        _model_name = c.string()
        focal_set, focal = _read_prior(c, 1)
        ar_set, ar = _read_prior(c, 1)
        skew_set, skew = _read_prior(c, 1)
        rd_set, rd = _read_prior(c, 4)
        td_set, td = _read_prior(c, 2)
        pos_set, pos = _read_prior(c, 3)
        orient_set, orient = _read_prior(c, 3)
        _read_prior(c, 1); _read_prior(c, 1); _read_prior(c, 1)
    elif ver == 2:
        p.image_width = c.i32()
        p.image_height = c.i32()
        _model_name = "PINHOLE"
        focal_set, focal = _read_prior(c, 1)
        ar_set, ar = _read_prior(c, 1)
        skew_set, skew = _read_prior(c, 1)
        rd_set, rd = _read_prior(c, 2)
        td_set, td = _read_prior(c, 2)
        pos_set, pos = _read_prior(c, 3)
        orient_set, orient = _read_prior(c, 3)
        _read_prior(c, 1); _read_prior(c, 1); _read_prior(c, 1)
    else:
        if ver >= 1:
            p.image_width = c.i32()
            p.image_height = c.i32()
        _model_name = "PINHOLE"
        focal_set, focal = _read_prior(c, 1)
        ppx_set, ppx = _read_prior(c, 1)
        ppy_set, ppy = _read_prior(c, 1)
        ar_set, ar = _read_prior(c, 1)
        skew_set, skew = _read_prior(c, 1)
        rd1_set, rd1 = _read_prior(c, 1)
        rd2_set, rd2 = _read_prior(c, 1)
        pp_set = ppx_set and ppy_set
        pp = np.array([ppx[0], ppy[0]])
        rd_set = rd1_set and rd2_set
        rd = np.array([rd1[0], rd2[0]])
    if ver >= 3:
        try:
            p.camera_intrinsics_model_type = CameraModelType[_model_name]
        except KeyError:
            p.camera_intrinsics_model_type = CameraModelType.PINHOLE
    if focal_set:
        p.focal_length = float(focal[0])
    if pp_set:
        p.principal_point = (float(pp[0]), float(pp[1]))
    if ar_set:
        p.aspect_ratio = float(ar[0])
    if skew_set:
        p.skew = float(skew[0])
    if rd_set:
        p.radial_distortion = tuple(float(x) for x in rd)
    if td_set:
        p.tangential_distortion = (float(td[0]), float(td[1]))
    if pos_set:
        p.position = pos
    if orient_set:
        p.orientation = orient
    return p


def _read_camera(c: _Cursor):
    ver = c.version("Camera")
    if ver == 0:
        # pinhole-only path: 6 extrinsics + 7 intrinsics doubles
        params = c.f64(13)
        w = c.i32()
        h = c.i32()
        extrinsics = params[:6]
        intr = np.zeros(MAX_INTRINSICS)
        intr[:7] = params[6:13]
        return (CameraModelType.PINHOLE, extrinsics, intr, w, h)
    # version 1: extrinsics + polymorphic intrinsics model
    extrinsics = c.f64(6)
    model_type, intr = _read_polymorphic_intrinsics(c)
    w = c.i32()
    h = c.i32()
    return (model_type, extrinsics, intr, w, h)


_POLY_NAME_TO_MODEL = {
    "theia::PinholeCameraModel": (CameraModelType.PINHOLE, 7),
    "theia::PinholeRadialTangentialCameraModel":
        (CameraModelType.PINHOLE_RADIAL_TANGENTIAL, 10),
    "theia::FisheyeCameraModel": (CameraModelType.FISHEYE, 9),
    "theia::FOVCameraModel": (CameraModelType.FOV, 6),
    "theia::DivisionUndistortionCameraModel":
        (CameraModelType.DIVISION_UNDISTORTION, 6),
}


def _read_polymorphic_intrinsics(c: _Cursor):
    """cereal polymorphic shared_ptr layout (observed + cereal sources):
      uint32 polymorphic id (0 = nullptr; msb flag = new registration,
        followed by the type-name string; ids count from 1),
      uint32 shared_ptr id (msb flag = first occurrence, object
        payload follows; otherwise a back-reference),
      payload = derived class version (one-time, PinholeCameraModel v1
        defers to base, pinhole_camera_model.h:170-178) + base class
        version (one-time, camera_intrinsics_model.h:216-218) +
        std::vector<double> parameters (u64 count + doubles)."""
    if "_poly_names" not in c.__dict__:
        c._poly_names = {}
        c._ptr_objects = {}
    poly_id = c.u32()
    if poly_id == 0:
        return CameraModelType.PINHOLE, np.zeros(MAX_INTRINSICS)
    if poly_id & 0x80000000:
        name = c.string()
        c._poly_names[len(c._poly_names) + 1] = name
    else:
        name = c._poly_names.get(poly_id, "theia::PinholeCameraModel")
    model_type, nparams = _POLY_NAME_TO_MODEL.get(
        name, (CameraModelType.PINHOLE, 7))

    ptr_id = c.u32()
    key = ptr_id & 0x7FFFFFFF
    if not (ptr_id & 0x80000000):
        return c._ptr_objects.get(key,
                                  (model_type, np.zeros(MAX_INTRINSICS)))
    c.version(name)                      # derived class version
    c.version("CameraIntrinsicsModel")   # base class version
    nvec = c.u64()
    params = c.f64(nvec)
    intr = np.zeros(MAX_INTRINSICS)
    k = min(nvec, MAX_INTRINSICS)
    intr[:k] = params[:k]
    c._ptr_objects[key] = (model_type, intr)
    return model_type, intr


def read_theia_reconstruction_native(path: str):
    """Parse via the C++ reader (native/theia_io.cc, built at first use
    by utils/native.py; a failed build raises). Returns None when the
    file fails to parse (the caller then runs the pure-Python parser,
    which says where)."""
    from ..utils.native import get_lib
    lib = get_lib()
    h = lib.theia_read(path.encode())
    if not h:
        return None
    try:
        nv = lib.theia_num_views(h)
        nt = lib.theia_num_tracks(h)
        no = lib.theia_num_obs(h)
        ns = lib.theia_names_size(h)
        vids = np.zeros(nv, np.uint32)
        est = np.zeros(nv, np.uint8)
        model = np.zeros(nv, np.int32)
        extr = np.zeros((nv, 6), np.float64)
        intr = np.zeros((nv, MAX_INTRINSICS), np.float64)
        wh = np.zeros((nv, 2), np.int32)
        group = np.zeros(nv, np.uint32)
        lib.theia_get_views(h, vids, est, model,
                            extr.reshape(-1), intr.reshape(-1),
                            wh.reshape(-1), group)
        names_buf = ctypes.create_string_buffer(max(int(ns), 1))
        name_off = np.zeros(nv + 1, np.int64)
        lib.theia_get_names(h, names_buf, name_off)
        names_raw = names_buf.raw[:ns].decode("utf-8")
        p_model = np.zeros(nv, np.int32)
        p_wh = np.zeros((nv, 2), np.int32)
        p_set = np.zeros(nv, np.uint8)
        p_vals = np.zeros((nv, 17), np.float64)
        lib.theia_get_priors(h, p_model, p_wh.reshape(-1), p_set,
                             p_vals.reshape(-1))
        tids = np.zeros(nt, np.uint32)
        test_ = np.zeros(nt, np.uint8)
        points = np.zeros((nt, 4), np.float64)
        colors = np.zeros((nt, 3), np.uint8)
        lib.theia_get_tracks(h, tids, test_, points.reshape(-1),
                             colors.reshape(-1))
        ov = np.zeros(no, np.uint32)
        ot = np.zeros(no, np.uint32)
        oxy = np.zeros((no, 2), np.float64)
        lib.theia_get_obs(h, ov, ot, oxy.reshape(-1))
    finally:
        lib.theia_recon_free(h)

    recon = Reconstruction()
    order = np.argsort(vids, kind="stable")
    id_remap = {}
    for i in order:
        name = names_raw[name_off[i]:name_off[i + 1]]
        new_vid = recon.add_view(name, group=int(group[i]))
        id_remap[int(vids[i])] = new_vid
        view = recon.view(new_vid)
        view.is_estimated = bool(est[i])
        cam = view.camera
        cam.model_type = CameraModelType(int(model[i]))
        cam.extrinsics = extr[i].copy()
        cam.intrinsics = intr[i].copy()
        cam.image_width = int(wh[i, 0])
        cam.image_height = int(wh[i, 1])
        pr = CameraIntrinsicsPrior()
        pr.image_width = int(p_wh[i, 0])
        pr.image_height = int(p_wh[i, 1])
        pr.camera_intrinsics_model_type = CameraModelType(
            int(p_model[i]))
        s, v = int(p_set[i]), p_vals[i]
        if s & 1:
            pr.focal_length = float(v[0])
        if s & 2:
            pr.principal_point = (float(v[1]), float(v[2]))
        if s & 4:
            pr.aspect_ratio = float(v[3])
        if s & 8:
            pr.skew = float(v[4])
        if s & 16:
            pr.radial_distortion = tuple(float(x) for x in v[5:9])
        if s & 32:
            pr.tangential_distortion = (float(v[9]), float(v[10]))
        if s & 64:
            pr.position = v[11:14].copy()
        if s & 128:
            pr.orientation = v[14:17].copy()
        view.prior = pr

    tid_remap = {}
    for i in np.argsort(tids, kind="stable"):
        new_tid = recon.add_track()
        tid_remap[int(tids[i])] = new_tid
        tr = recon.track(new_tid)
        tr.is_estimated = bool(test_[i])
        tr.point = points[i].copy()
        tr.color = colors[i].copy()

    for k in range(no):
        tid = int(ot[k])
        if tid in tid_remap:
            recon.add_observation(id_remap[int(ov[k])], tid_remap[tid],
                                  oxy[k])
    return recon


def read_theia_reconstruction(path: str,
                              prefer_native: bool = True
                              ) -> Reconstruction:
    """Parse a Theia .bin reconstruction into our data model: the C++
    reader when prefer_native (built at first use; a failed build
    raises), the pure-Python parser with prefer_native=False or when the
    C++ reader cannot parse the file."""
    if prefer_native:
        recon = read_theia_reconstruction_native(path)
        if recon is not None:
            return recon
    with open(path, "rb") as f:
        data = f.read()
    c = _Cursor(data)
    endian = c.u8()
    if endian != 1:
        raise ValueError("big-endian Theia files not supported")
    c.version("Reconstruction")
    next_track_id = c.u32()
    next_view_id = c.u32()

    n = c.u64()
    name_to_id = {}
    for _ in range(n):
        name = c.string()
        vid = c.u32()
        name_to_id[name] = vid

    recon = Reconstruction()

    n_views = c.u64()
    view_data = {}
    for _ in range(n_views):
        vid = c.u32()
        c.version("View")
        name = c.string()
        is_estimated = c.boolean()
        cam = _read_camera(c)
        prior = _read_intrinsics_prior(c)
        n_feat = c.u64()
        feats = {}
        for _ in range(n_feat):
            tid = c.u32()
            v = c.eigen()
            feats[tid] = v.reshape(-1)[:2]
        view_data[vid] = (name, is_estimated, cam, prior, feats)

    n_tracks = c.u64()
    track_data = {}
    for _ in range(n_tracks):
        tid = c.u32()
        c.version("Track")
        is_estimated = c.boolean()
        n_tv = c.u64()
        tviews = [c.u32() for _ in range(n_tv)]
        point = c.eigen().reshape(-1)
        color = c.eigen(dtype="<u1").reshape(-1)
        track_data[tid] = (is_estimated, tviews, point, color)

    # view -> intrinsics group
    n_vg = c.u64()
    view_group = {}
    for _ in range(n_vg):
        v = c.u32()
        g = c.u32()
        view_group[v] = g

    # rebuild the host model preserving ids via sorted insertion
    id_remap = {}
    for vid in sorted(view_data.keys()):
        name, is_estimated, cam, prior, feats = view_data[vid]
        new_vid = recon.add_view(name, group=view_group.get(vid))
        id_remap[vid] = new_vid
        view = recon.view(new_vid)
        view.is_estimated = is_estimated
        model_type, extrinsics, intr, w, h = cam
        view.camera.model_type = model_type
        view.camera.extrinsics = np.asarray(extrinsics, float)
        view.camera.intrinsics = np.asarray(intr, float)
        view.camera.image_width = w
        view.camera.image_height = h
        view.prior = prior

    tid_remap = {}
    for tid in sorted(track_data.keys()):
        is_estimated, tviews, point, color = track_data[tid]
        new_tid = recon.add_track()
        tid_remap[tid] = new_tid
        tr = recon.track(new_tid)
        tr.is_estimated = is_estimated
        tr.point = np.asarray(point, float)
        tr.color = np.asarray(color, np.uint8)

    for vid, (name, _, _, _, feats) in view_data.items():
        for tid, feat in feats.items():
            if tid in tid_remap:
                recon.add_observation(id_remap[vid], tid_remap[tid],
                                     feat)
    return recon


# ---------------------------------------------------------------------------
# writer (the inverse of the parser above; ref:
# io/reconstruction_writer.cc:53-66 uses cereal
# PortableBinaryOutputArchive with the same serialize() declarations)


_MODEL_TO_POLY_NAME = {m: n for n, (m, _) in _POLY_NAME_TO_MODEL.items()}
_MODEL_NPARAMS = {m: k for _, (m, k) in _POLY_NAME_TO_MODEL.items()}


class _Writer:
    def __init__(self):
        self.buf = bytearray()
        self._versions: Dict[str, int] = {}
        self._poly_ids: Dict[str, int] = {}
        self._next_ptr_id = 0

    def raw(self, b: bytes):
        self.buf += b

    def u8(self, v):
        self.buf += struct.pack("<B", v)

    def u32(self, v):
        self.buf += struct.pack("<I", v)

    def i32(self, v):
        self.buf += struct.pack("<i", v)

    def u64(self, v):
        self.buf += struct.pack("<Q", v)

    def f64(self, vals):
        self.buf += np.asarray(vals, "<f8").tobytes()

    def boolean(self, v):
        self.u8(1 if v else 0)

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.raw(b)

    def version(self, type_key: str, ver: int):
        """cereal writes the class version u32 once, at the first
        occurrence of each versioned type per archive."""
        if type_key not in self._versions:
            self._versions[type_key] = ver
            self.u32(ver)

    def eigen(self, m, dtype="<f8"):
        arr = np.asarray(m, dtype)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        self.i32(arr.shape[0])
        self.i32(arr.shape[1])
        self.raw(arr.T.tobytes())  # column-major


def _write_prior(w: _Writer, n: int, is_set: bool, values):
    w.version(f"Prior<{n}>", 0)
    w.boolean(is_set)
    vals = np.zeros(n)
    if values is not None:
        v = np.atleast_1d(np.asarray(values, float))
        vals[:min(n, len(v))] = v[:n]
    w.f64(vals)


def _write_intrinsics_prior(w: _Writer, p: CameraIntrinsicsPrior):
    w.version("CameraIntrinsicsPrior", 4)
    w.i32(p.image_width or 0)
    w.i32(p.image_height or 0)
    w.string(p.camera_intrinsics_model_type.name)
    _write_prior(w, 1, p.focal_length is not None, p.focal_length)
    _write_prior(w, 2, p.principal_point is not None, p.principal_point)
    _write_prior(w, 1, p.aspect_ratio is not None, p.aspect_ratio)
    _write_prior(w, 1, p.skew is not None, p.skew)
    _write_prior(w, 4, p.radial_distortion is not None,
                 p.radial_distortion)
    _write_prior(w, 2, p.tangential_distortion is not None,
                 p.tangential_distortion)
    _write_prior(w, 3, p.position is not None, p.position)
    _write_prior(w, 3, p.orientation is not None, p.orientation)
    _write_prior(w, 1, False, None)  # latitude
    _write_prior(w, 1, False, None)  # longitude
    _write_prior(w, 1, False, None)  # altitude


def _write_camera(w: _Writer, camera, group_ptr_key,
                  group_first: Dict[int, int]):
    """Camera v1: extrinsics binary + polymorphic intrinsics shared_ptr
    + image size. Views sharing an intrinsics group emit cereal
    back-references so the reference reconstructs genuinely shared
    intrinsics objects."""
    w.version("Camera", 1)
    w.f64(np.asarray(camera.extrinsics, float)[:6])
    name = _MODEL_TO_POLY_NAME[camera.model_type]
    if name not in w._poly_ids:
        w._poly_ids[name] = len(w._poly_ids) + 1
        w.u32(w._poly_ids[name] | 0x80000000)
        w.string(name)
    else:
        w.u32(w._poly_ids[name])
    if group_ptr_key in group_first:
        w.u32(group_first[group_ptr_key])  # back-reference, no payload
    else:
        w._next_ptr_id += 1
        group_first[group_ptr_key] = w._next_ptr_id
        w.u32(w._next_ptr_id | 0x80000000)
        w.version(name, 1 if name == "theia::PinholeCameraModel" else 0)
        w.version("CameraIntrinsicsModel", 0)
        nparams = _MODEL_NPARAMS[camera.model_type]
        w.u64(nparams)
        w.f64(np.asarray(camera.intrinsics, float)[:nparams])
    w.i32(camera.image_width or 0)
    w.i32(camera.image_height or 0)


def write_theia_reconstruction(path: str, recon: Reconstruction):
    """Serialize our Reconstruction as a Theia-readable cereal
    PortableBinary .bin file (round-trips through
    read_theia_reconstruction and through the reference's
    ReadReconstruction)."""
    w = _Writer()
    w.u8(1)  # little-endian marker (PortableBinaryOutputArchive)
    w.version("Reconstruction", 0)
    vids = sorted(recon.views.keys())
    tids = sorted(recon.tracks.keys())
    w.u32((max(tids) + 1) if tids else 0)   # next_track_id
    w.u32((max(vids) + 1) if vids else 0)   # next_view_id

    w.u64(len(vids))
    for vid in vids:
        w.string(recon.views[vid].name)
        w.u32(vid)

    group_of = getattr(recon, "view_groups", None) or {}
    group_first: Dict[int, int] = {}
    w.u64(len(vids))
    for vid in vids:
        view = recon.views[vid]
        w.u32(vid)
        w.version("View", 0)
        w.string(view.name)
        w.boolean(view.is_estimated)
        gkey = group_of.get(vid, ("solo", vid))
        _write_camera(w, view.camera, gkey, group_first)
        _write_intrinsics_prior(w, view.prior)
        feats = view.features
        w.u64(len(feats))
        for tid in sorted(feats.keys()):
            w.u32(tid)
            w.eigen(np.asarray(feats[tid], float)[:2])

    w.u64(len(tids))
    for tid in tids:
        tr = recon.tracks[tid]
        w.u32(tid)
        w.version("Track", 0)
        w.boolean(tr.is_estimated)
        tviews = sorted(tr.views)
        w.u64(len(tviews))
        for v in tviews:
            w.u32(v)
        w.eigen(np.asarray(tr.point, float)[:4])
        w.eigen(np.asarray(tr.color, np.uint8)[:3], dtype="<u1")

    # view -> intrinsics-group map and group -> views map
    gid_of = {}
    groups: Dict[int, list] = {}
    next_gid = 0
    for vid in vids:
        gkey = group_of.get(vid, ("solo", vid))
        if gkey not in gid_of:
            gid_of[gkey] = next_gid
            next_gid += 1
        groups.setdefault(gid_of[gkey], []).append(vid)
    w.u64(len(vids))
    for vid in vids:
        w.u32(vid)
        w.u32(gid_of[group_of.get(vid, ("solo", vid))])
    w.u64(len(groups))
    for gid in sorted(groups.keys()):
        w.u32(gid)
        w.u64(len(groups[gid]))
        for v in sorted(groups[gid]):
            w.u32(v)

    with open(path, "wb") as f:
        f.write(bytes(w.buf))
