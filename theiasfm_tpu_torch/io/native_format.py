"""Native reconstruction serialization, npz-based (port of
theiasfm_tpu/io/native_format.py).

The role of ref: src/theia/io/reconstruction_{reader,writer}.cc (cereal
binary snapshots used for checkpoint/resume, SURVEY.md §5) — but stored
as a compressed numpy archive: columnar, mmap-friendly, and directly
loadable into the device SoA without a per-object walk.
"""
from __future__ import annotations

import json

import numpy as np

from ..camera.models import CameraModelType
from ..sfm.reconstruction import Reconstruction


FORMAT_VERSION = 1


def write_reconstruction(recon: Reconstruction, path: str):
    vids = sorted(recon.views.keys())
    tids = sorted(recon.tracks.keys())
    tid_idx = {t: i for i, t in enumerate(tids)}
    names = [recon.views[v].name for v in vids]
    extr = np.stack([recon.views[v].camera.extrinsics for v in vids]) \
        if vids else np.zeros((0, 6))
    intr = np.stack([recon.views[v].camera.intrinsics for v in vids]) \
        if vids else np.zeros((0, 10))
    model_types = np.asarray(
        [int(recon.views[v].camera.model_type) for v in vids], np.int32)
    img_sizes = np.asarray(
        [(recon.views[v].camera.image_width,
          recon.views[v].camera.image_height) for v in vids], np.int32
    ) if vids else np.zeros((0, 2), np.int32)
    v_est = np.asarray([recon.views[v].is_estimated for v in vids], bool)
    groups = np.asarray([recon.view_groups[v] for v in vids], np.int64)

    points = np.stack([recon.tracks[t].point for t in tids]) \
        if tids else np.zeros((0, 4))
    colors = np.stack([recon.tracks[t].color for t in tids]) \
        if tids else np.zeros((0, 3), np.uint8)
    t_est = np.asarray([recon.tracks[t].is_estimated for t in tids], bool)

    obs_view, obs_track, obs_pix = [], [], []
    for i, v in enumerate(vids):
        for t, feat in recon.views[v].features.items():
            if t in tid_idx:
                obs_view.append(i)
                obs_track.append(tid_idx[t])
                obs_pix.append(feat)
    obs_view = np.asarray(obs_view, np.int64)
    obs_track = np.asarray(obs_track, np.int64)
    obs_pix = (np.stack(obs_pix) if len(obs_pix)
               else np.zeros((0, 2)))

    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        names=json.dumps(names),
        extrinsics=extr, intrinsics=intr, model_types=model_types,
        image_sizes=img_sizes, views_estimated=v_est, groups=groups,
        points=points, colors=colors, tracks_estimated=t_est,
        obs_view=obs_view, obs_track=obs_track, obs_pix=obs_pix,
    )


def read_reconstruction(path: str) -> Reconstruction:
    # each member decompressed once: an NpzFile decompresses a member on
    # every z[key], which made the per-track and per-observation loops
    # below quadratic (JAX's reader keeps that; 191 s for 2,321 tracks
    # and 31,134 observations on the H100's host)
    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    names = json.loads(str(z["names"]))
    recon = Reconstruction()
    vids = []
    for i, name in enumerate(names):
        vid = recon.add_view(name, group=int(z["groups"][i]))
        vids.append(vid)
        view = recon.view(vid)
        view.camera.extrinsics = z["extrinsics"][i].copy()
        view.camera.intrinsics = z["intrinsics"][i].copy()
        view.camera.model_type = CameraModelType(int(z["model_types"][i]))
        view.camera.image_width = int(z["image_sizes"][i][0])
        view.camera.image_height = int(z["image_sizes"][i][1])
        view.is_estimated = bool(z["views_estimated"][i])
    tids = []
    for j in range(z["points"].shape[0]):
        tid = recon.add_track()
        tids.append(tid)
        tr = recon.track(tid)
        tr.point = z["points"][j].copy()
        tr.color = z["colors"][j].copy()
        tr.is_estimated = bool(z["tracks_estimated"][j])
    for k in range(z["obs_view"].shape[0]):
        recon.add_observation(vids[int(z["obs_view"][k])],
                              tids[int(z["obs_track"][k])],
                              z["obs_pix"][k])
    return recon
