"""Bundler bundle.out reader/writer (port of theiasfm_tpu/io/bundler.py;
rotations in float64 on the host, io/_rotation.py).

ref: src/theia/io/read_bundler_files.{h,cc},
write_bundler_files.{h,cc}, bundler_file_reader.{h,cc}. Bundler
convention: camera rotation R maps world->camera with the camera
looking down -z; theia flips with diag(1,-1,-1)
(same convention handling as the reference readers).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from . import _rotation as rot
from ..sfm.reconstruction import Reconstruction

_FLIP = np.diag([1.0, -1.0, -1.0])


def read_bundler(lists_file: str, bundle_file: str) -> Reconstruction:
    """Read a bundler reconstruction (lists.txt + bundle.out)."""
    names: List[str] = []
    focals: List[float] = []
    with open(lists_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            names.append(os.path.basename(parts[0]))
            focals.append(float(parts[2]) if len(parts) >= 3 else 0.0)

    with open(bundle_file) as f:
        toks = f.read().split()
    pos = 0
    if toks[0].startswith("#"):
        # header line "# Bundle file v0.3"
        with open(bundle_file) as f:
            f.readline()
            toks = f.read().split()
    num_cams, num_pts = int(toks[0]), int(toks[1])
    pos = 2

    recon = Reconstruction()
    vids = []
    for i in range(num_cams):
        vid = recon.add_view(names[i] if i < len(names) else f"img{i}")
        vids.append(vid)
        view = recon.views[vid]
        f_len = float(toks[pos]); k1 = float(toks[pos + 1])
        k2 = float(toks[pos + 2]); pos += 3
        R = np.asarray([float(t) for t in toks[pos:pos + 9]]
                       ).reshape(3, 3); pos += 9
        t = np.asarray([float(t) for t in toks[pos:pos + 3]]); pos += 3
        if f_len > 0:
            R_theia = _FLIP @ R
            c = -R.T @ t
            view.camera.intrinsics[0] = f_len
            view.camera.intrinsics[5] = k1
            view.camera.intrinsics[6] = k2
            view.camera.extrinsics[:3] = c
            view.camera.extrinsics[3:6] = rot.rotation_matrix_to_angle_axis(
                R_theia)
            view.is_estimated = True

    for _ in range(num_pts):
        xyz = np.asarray([float(t) for t in toks[pos:pos + 3]]); pos += 3
        color = np.asarray([int(t) for t in toks[pos:pos + 3]],
                           np.uint8); pos += 3
        n_obs = int(toks[pos]); pos += 1
        tid = recon.add_track()
        tr = recon.tracks[tid]
        tr.point = np.append(xyz, 1.0)
        tr.color = color
        tr.is_estimated = True
        for _ in range(n_obs):
            cam_idx = int(toks[pos]); pos += 4
            x, y = float(toks[pos - 2]), float(toks[pos - 1])
            if cam_idx < len(vids):
                view = recon.views[vids[cam_idx]]
                pp = view.camera.intrinsics[3:5]
                # bundler features are centered at the principal point
                # with y up; theia uses pixel coords y down
                feat = np.asarray([x + pp[0], -y + pp[1]])
                if tid not in view.features:
                    recon.add_observation(vids[cam_idx], tid, feat)
    return recon


def write_bundler(recon: Reconstruction, lists_file: str,
                  bundle_file: str):
    vids = sorted(recon.views.keys())
    vid_idx = {v: i for i, v in enumerate(vids)}
    with open(lists_file, "w") as f:
        for v in vids:
            cam = recon.views[v].camera
            f.write(f"{recon.views[v].name} 0 {cam.intrinsics[0]}\n")
    tids = [t for t in sorted(recon.tracks.keys())
            if recon.tracks[t].is_estimated]
    with open(bundle_file, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(vids)} {len(tids)}\n")
        for v in vids:
            cam = recon.views[v].camera
            if recon.views[v].is_estimated:
                R_theia = rot.angle_axis_to_rotation_matrix(
                    cam.extrinsics[3:6])
                R = _FLIP @ R_theia
                t = -R @ cam.extrinsics[:3]
                f.write(f"{cam.intrinsics[0]} {cam.intrinsics[5]} "
                        f"{cam.intrinsics[6]}\n")
                for row in R:
                    f.write(f"{row[0]} {row[1]} {row[2]}\n")
                f.write(f"{t[0]} {t[1]} {t[2]}\n")
            else:
                f.write("0 0 0\n0 0 0\n0 0 0\n0 0 0\n0 0 0\n")
        for t in tids:
            tr = recon.tracks[t]
            xyz = tr.xyz()
            f.write(f"{xyz[0]} {xyz[1]} {xyz[2]}\n")
            f.write(f"{tr.color[0]} {tr.color[1]} {tr.color[2]}\n")
            obs = [(v, recon.views[v].features[t]) for v in tr.views]
            f.write(str(len(obs)))
            for v, feat in obs:
                pp = recon.views[v].camera.intrinsics[3:5]
                f.write(f" {vid_idx[v]} 0 {feat[0] - pp[0]} "
                        f"{-(feat[1] - pp[1])}")
            f.write("\n")
