"""Lowe SIFT key file I/O, text and binary variants (port of
theiasfm_tpu/io/sift_key.py).

ref: src/theia/io/sift_text_file.{h,cc}, sift_binary_file.{h,cc},
read_keypoints_and_descriptors.{h,cc}. Text format (Lowe's `sift`
tool): header "<num> <dim>", then per feature a line
"row col scale orientation" followed by dim integers in [0, 255].
Binary format here matches the reference's simple blob layout:
int32 num, int32 dim, then per feature 4 floats + dim floats.
"""
from __future__ import annotations

import struct

import numpy as np


def write_sift_text(path: str, keypoints: np.ndarray,
                    descriptors: np.ndarray):
    """keypoints (N, 4) [x, y, scale, orientation]; descriptors
    (N, D) floats (L2-normalized; stored scaled by 512 like Lowe)."""
    n, d = descriptors.shape
    with open(path, "w") as f:
        f.write(f"{n} {d}\n")
        for i in range(n):
            x, y, s, o = keypoints[i][:4]
            f.write(f"{y:.2f} {x:.2f} {s:.2f} {o:.3f}\n")
            vals = np.clip(descriptors[i] * 512.0, 0, 255).astype(int)
            for start in range(0, d, 20):
                f.write(" ".join(str(v) for v in
                                 vals[start:start + 20]) + "\n")


def read_sift_text(path: str):
    with open(path) as f:
        toks = f.read().split()
    n, d = int(toks[0]), int(toks[1])
    pos = 2
    kps = np.zeros((n, 4))
    desc = np.zeros((n, d), np.float32)
    for i in range(n):
        row, col, s, o = (float(toks[pos]), float(toks[pos + 1]),
                          float(toks[pos + 2]), float(toks[pos + 3]))
        pos += 4
        kps[i] = [col, row, s, o]
        desc[i] = [float(t) for t in toks[pos:pos + d]]
        pos += d
    desc /= 512.0
    return kps, desc


def write_sift_binary(path: str, keypoints: np.ndarray,
                      descriptors: np.ndarray):
    n, d = descriptors.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", n, d))
        for i in range(n):
            f.write(struct.pack("<4f", *[float(v)
                                         for v in keypoints[i][:4]]))
            f.write(np.asarray(descriptors[i], "<f4").tobytes())


def read_sift_binary(path: str):
    with open(path, "rb") as f:
        n, d = struct.unpack("<ii", f.read(8))
        kps = np.zeros((n, 4))
        desc = np.zeros((n, d), np.float32)
        for i in range(n):
            kps[i] = struct.unpack("<4f", f.read(16))
            desc[i] = np.frombuffer(f.read(4 * d), "<f4")
    return kps, desc
