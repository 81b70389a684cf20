"""COLMAP text-format export: cameras.txt, images.txt, points3D.txt (port
of theiasfm_tpu/io/colmap.py; rotations in float64 on the host).

ref: src/theia/io/write_colmap_files.{h,cc}. COLMAP image pose is
world->camera (R, t) with quaternion [qw qx qy qz], t = -R c.
"""
from __future__ import annotations

import os

from . import _rotation as rot
from ..sfm.reconstruction import Reconstruction


def write_colmap(recon: Reconstruction, directory: str):
    os.makedirs(directory, exist_ok=True)
    vids = [v for v in sorted(recon.views.keys())
            if recon.views[v].is_estimated]
    tids = [t for t in sorted(recon.tracks.keys())
            if recon.tracks[t].is_estimated]
    tid_idx = {t: i + 1 for i, t in enumerate(tids)}

    with open(os.path.join(directory, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for i, v in enumerate(vids):
            cam = recon.views[v].camera
            w = cam.image_width or int(2 * cam.intrinsics[3]) or 1
            h = cam.image_height or int(2 * cam.intrinsics[4]) or 1
            # PINHOLE: fx fy cx cy
            fx = cam.intrinsics[0]
            fy = fx * cam.intrinsics[1]
            f.write(f"{i + 1} PINHOLE {w} {h} {fx} {fy} "
                    f"{cam.intrinsics[3]} {cam.intrinsics[4]}\n")

    with open(os.path.join(directory, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ "
                "CAMERA_ID NAME / POINTS2D[]\n")
        for i, v in enumerate(vids):
            view = recon.views[v]
            cam = view.camera
            q = rot.angle_axis_to_quaternion(cam.extrinsics[3:6])
            R = rot.angle_axis_to_rotation_matrix(cam.extrinsics[3:6])
            t = -R @ cam.extrinsics[:3]
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {i + 1} {view.name}\n")
            obs = [(tid, feat) for tid, feat in view.features.items()
                   if tid in tid_idx]
            f.write(" ".join(f"{feat[0]} {feat[1]} {tid_idx[tid]}"
                             for tid, feat in obs) + "\n")

    with open(os.path.join(directory, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] (IMAGE_ID POINT2D_IDX)\n")
        vid_idx = {v: i + 1 for i, v in enumerate(vids)}
        for t in tids:
            tr = recon.tracks[t]
            xyz = tr.xyz()
            f.write(f"{tid_idx[t]} {xyz[0]} {xyz[1]} {xyz[2]} "
                    f"{tr.color[0]} {tr.color[1]} {tr.color[2]} 0")
            for v in tr.views:
                if v in vid_idx:
                    f.write(f" {vid_idx[v]} 0")
            f.write("\n")
