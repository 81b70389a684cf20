"""1DSfM dataset importer, Wilson & Snavely datasets (port of
theiasfm_tpu/io/one_dsfm.py; rotations in float64 on the host).

ref: src/theia/io/read_1dsfm.{h,cc} — reads list.txt (+cc.txt),
coords.txt (per-view keypoints+colors), tracks.txt, EGs.txt (pairwise
epipolar geometry in Bundler coordinates), producing a Reconstruction
(views+tracks, unestimated) and a ViewGraph. Conventions mirrored from
read_1dsfm.cc:160-370 including the bundler->theia basis flip
diag(1,-1,-1) and the 1.2*px focal fallback.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Set

import numpy as np

from . import _rotation as rot
from ..sfm.reconstruction import Reconstruction
from ..sfm.view_graph import TwoViewInfo, ViewGraph


def read_1dsfm(dataset_directory: str):
    """Returns (Reconstruction, ViewGraph)."""
    recon = Reconstruction()
    graph = ViewGraph()

    # cc.txt: valid image indices (optional)
    valid: Set[int] = set()
    cc_path = os.path.join(dataset_directory, "cc.txt")
    if os.path.exists(cc_path):
        with open(cc_path) as f:
            for tok in f.read().split():
                valid.add(int(tok))

    # list.txt: one image per line (+ optional "0 focal")
    removed: Set[int] = set()
    with open(os.path.join(dataset_directory, "list.txt")) as f:
        for idx, line in enumerate(f):
            parts = line.split()
            if not parts:
                continue
            name = os.path.basename(parts[0])
            vid = recon.add_view(name)
            if valid and idx not in valid:
                removed.add(vid)
                continue
            if len(parts) >= 3:
                recon.views[vid].prior.focal_length = float(parts[2])

    # coords.txt: per-view keypoints
    feature_coords: Dict[int, np.ndarray] = {}
    feature_colors: Dict[int, np.ndarray] = {}
    header_re = re.compile(
        r"#index = (\d+), name = (\S+) keys = (\d+), px = ([\d.eE+-]+), "
        r"py = ([\d.eE+-]+), focal = ([\d.eE+-]+)")
    with open(os.path.join(dataset_directory, "coords.txt")) as f:
        line = f.readline()
        while line:
            m = header_re.match(line.strip())
            if not m:
                line = f.readline()
                continue
            view_id = int(m.group(1))
            num_keys = int(m.group(3))
            px, py = float(m.group(4)), float(m.group(5))
            coords = np.zeros((num_keys, 2))
            colors = np.zeros((num_keys, 3), np.uint8)
            keep = view_id in recon.views and view_id not in removed
            for i in range(num_keys):
                row = f.readline().split()
                if keep and len(row) >= 7:
                    coords[i] = [float(row[1]), float(row[2])]
                    colors[i] = [int(row[5]), int(row[6]), int(row[7])] \
                        if len(row) >= 8 else [int(row[4]), int(row[5]),
                                               int(row[6])]
            if keep:
                feature_coords[view_id] = coords
                feature_colors[view_id] = colors
                prior = recon.views[view_id].prior
                prior.image_width = int(px * 2)
                prior.image_height = int(py * 2)
                prior.principal_point = (px, py)
                recon.views[view_id].camera.set_from_prior(prior)
            line = f.readline()

    # tracks.txt
    tracks_path = os.path.join(dataset_directory, "tracks.txt")
    if os.path.exists(tracks_path):
        with open(tracks_path) as f:
            toks = f.read().split()
        pos = 0
        num_tracks = int(toks[pos]); pos += 1
        for _ in range(num_tracks):
            n = int(toks[pos]); pos += 1
            obs = []
            color = np.zeros(3)
            ok = True
            for _ in range(n):
                v = int(toks[pos]); fid = int(toks[pos + 1]); pos += 2
                if v not in feature_coords or \
                        fid >= len(feature_coords[v]):
                    ok = False
                    continue
                obs.append((v, feature_coords[v][fid]))
                color += feature_colors[v][fid]
            seen = set()
            obs = [o for o in obs
                   if not (o[0] in seen or seen.add(o[0]))]
            if ok and len(obs) >= 2:
                tid = recon.add_track()
                for v, feat in obs:
                    recon.add_observation(v, tid, feat)
                recon.tracks[tid].color = (color / max(len(obs), 1)
                                           ).astype(np.uint8)

    # EGs.txt
    flip = np.diag([1.0, -1.0, -1.0])
    with open(os.path.join(dataset_directory, "EGs.txt")) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 14:
                continue
            v1, v2 = int(vals[0]), int(vals[1])
            if v1 not in recon.views or v2 not in recon.views or \
                    v1 in removed or v2 in removed:
                continue
            R = np.asarray([float(x) for x in vals[2:11]]).reshape(3, 3)
            R = flip @ R.T @ flip
            t = flip @ np.asarray([float(x) for x in vals[11:14]])
            info = TwoViewInfo()
            info.rotation_2 = rot.rotation_matrix_to_angle_axis(R)
            info.position_2 = t
            for (v, attr) in ((v1, "focal_length_1"),
                              (v2, "focal_length_2")):
                prior = recon.views[v].prior
                if prior.focal_length:
                    setattr(info, attr, prior.focal_length)
                elif prior.principal_point:
                    setattr(info, attr, 1.2 * prior.principal_point[0])
            common = set(recon.views[v1].features) & \
                set(recon.views[v2].features)
            info.num_verified_matches = len(common)
            info.visibility_score = len(common)
            graph.add_edge(v1, v2, info)

    # drop views not in the largest component bookkeeping set
    for vid in removed:
        recon.remove_view(vid)
    return recon, graph
