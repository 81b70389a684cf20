"""Binary keypoints+descriptors feature files (port of
theiasfm_tpu/io/features_files.py).

ref: src/theia/io/write_keypoints_and_descriptors.{h,cc} and
read_keypoints_and_descriptors.{h,cc} — the reference serializes one
image's keypoints + descriptors per file (used by the extract_features
app's --output directory). Format here: a little-endian header
(magic, counts, dims) + raw float32 arrays; the keypoint record is
[x, y, scale, orientation] like our KeypointsAndDescriptors.
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"TFTK"  # theiasfm-tpu feature file


def write_keypoints_and_descriptors(path: str, keypoints: np.ndarray,
                                    descriptors: np.ndarray) -> None:
    kp = np.asarray(keypoints, np.float32)
    if kp.ndim == 1:
        kp = kp.reshape(0, 4)
    desc = np.asarray(descriptors, np.float32)
    n = kp.shape[0]
    assert desc.shape[0] == n, (kp.shape, desc.shape)
    kdim = kp.shape[1] if n else 4
    ddim = desc.shape[1] if n else 128
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<III", n, kdim, ddim))
        f.write(kp.tobytes())
        f.write(desc.tobytes())


def read_keypoints_and_descriptors(path: str):
    """Returns (keypoints (N, kdim) f32, descriptors (N, ddim) f32)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a feature file")
        n, kdim, ddim = struct.unpack("<III", f.read(12))
        kp = np.frombuffer(f.read(4 * n * kdim),
                           np.float32).reshape(n, kdim).copy()
        desc = np.frombuffer(f.read(4 * n * ddim),
                             np.float32).reshape(n, ddim).copy()
    return kp, desc
