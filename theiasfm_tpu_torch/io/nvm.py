"""VisualSfM NVM format reader/writer (port of theiasfm_tpu/io/nvm.py;
rotations in float64 on the host, io/_rotation.py).

ref: src/theia/io/import_nvm_file.cc (via vendored visual_sfm lib) and
write_nvm_file.cc. NVM v3 text: header, camera lines
<name> <focal> <qw qx qy qz> <cx cy cz> <radial> 0, then points
<xyz> <rgb> <num_meas> (<img_idx> <feat_idx> <x> <y>)*  with
measurements centered on the principal point.
"""
from __future__ import annotations

import os

import numpy as np

from . import _rotation as rot
from ..sfm.reconstruction import Reconstruction


def read_nvm(path: str) -> Reconstruction:
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    assert lines[0].startswith("NVM_V3"), "only NVM_V3 supported"
    i = 1
    while not lines[i]:
        i += 1
    num_cams = int(lines[i]); i += 1
    recon = Reconstruction()
    vids = []
    pps = []
    for c in range(num_cams):
        parts = lines[i].split(); i += 1
        name = os.path.basename(parts[0])
        focal = float(parts[1])
        q = np.asarray([float(x) for x in parts[2:6]])
        cpos = np.asarray([float(x) for x in parts[6:9]])
        r = float(parts[9])
        vid = recon.add_view(name)
        vids.append(vid)
        view = recon.views[vid]
        R = rot.quaternion_to_rotation_matrix(q)
        view.camera.intrinsics[0] = focal
        # NVM uses the division-like radial model; map to our division
        view.camera.extrinsics[:3] = cpos
        view.camera.extrinsics[3:6] = rot.rotation_matrix_to_angle_axis(R)
        view.is_estimated = True
        pps.append(np.zeros(2))

    while not lines[i]:
        i += 1
    num_pts = int(lines[i]); i += 1
    for p in range(num_pts):
        parts = lines[i].split(); i += 1
        xyz = np.asarray([float(x) for x in parts[0:3]])
        rgb = np.asarray([int(x) for x in parts[3:6]], np.uint8)
        n_meas = int(parts[6])
        tid = recon.add_track()
        tr = recon.tracks[tid]
        tr.point = np.append(xyz, 1.0)
        tr.color = rgb
        tr.is_estimated = True
        off = 7
        for m in range(n_meas):
            img = int(parts[off]); off += 2
            x, y = float(parts[off]), float(parts[off + 1]); off += 2
            if img < len(vids):
                vid = vids[img]
                if tid not in recon.views[vid].features:
                    recon.add_observation(vid, tid,
                                          np.asarray([x, y]) + pps[img])
    return recon


def write_nvm(recon: Reconstruction, path: str):
    vids = [v for v in sorted(recon.views.keys())
            if recon.views[v].is_estimated]
    vid_idx = {v: i for i, v in enumerate(vids)}
    tids = [t for t in sorted(recon.tracks.keys())
            if recon.tracks[t].is_estimated]
    with open(path, "w") as f:
        f.write("NVM_V3\n\n")
        f.write(f"{len(vids)}\n")
        for v in vids:
            view = recon.views[v]
            cam = view.camera
            q = rot.angle_axis_to_quaternion(cam.extrinsics[3:6])
            c = cam.extrinsics[:3]
            f.write(f"{view.name} {cam.intrinsics[0]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{c[0]} {c[1]} {c[2]} 0 0\n")
        f.write(f"\n{len(tids)}\n")
        for t in tids:
            tr = recon.tracks[t]
            xyz = tr.xyz()
            obs = [(v, recon.views[v].features[t]) for v in tr.views
                   if v in vid_idx]
            f.write(f"{xyz[0]} {xyz[1]} {xyz[2]} "
                    f"{tr.color[0]} {tr.color[1]} {tr.color[2]} "
                    f"{len(obs)}")
            for v, feat in obs:
                pp = recon.views[v].camera.intrinsics[3:5]
                f.write(f" {vid_idx[v]} 0 {feat[0] - pp[0]} "
                        f"{feat[1] - pp[1]}")
            f.write("\n")
