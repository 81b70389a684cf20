"""The rotations the text formats read and write, in float64 on the host.

The readers and writers convert rotations with the port's
math/rotation.py on float64 CPU tensors and hand numpy float64 back, so
no file costs a device launch and every number they format is a numpy
scalar (an f-string of a 0-d tensor would print `tensor(...)`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..math import rotation as rot


def _f64(fn, x) -> np.ndarray:
    return fn(torch.as_tensor(np.asarray(x, np.float64))).numpy()


def angle_axis_to_rotation_matrix(aa) -> np.ndarray:
    return _f64(rot.angle_axis_to_rotation_matrix, aa)


def rotation_matrix_to_angle_axis(R) -> np.ndarray:
    return _f64(rot.rotation_matrix_to_angle_axis, R)


def angle_axis_to_quaternion(aa) -> np.ndarray:
    return _f64(rot.angle_axis_to_quaternion, aa)


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    return _f64(rot.quaternion_to_rotation_matrix, q)
