"""Hand the state of a JAX-package bundle-adjustment problem to the port.

The caller converts the JAX BAProblem's fields to numpy arrays (a dict
of field name -> np.ndarray or None, e.g.
`{k: None if v is None else np.asarray(v) for k, v in p._asdict().items()}`)
and its BAOptions to a dict (`dataclasses.asdict`); this module turns
them into the port's BAProblem and BAOptions. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .bench_problem import resolve_device
from .sfm.ba.bundle_adjustment import BAOptions, BAProblem


def from_jax_arrays(fields: dict, device="cuda") -> BAProblem:
    """numpy arrays of the JAX BAProblem's fields -> BAProblem on
    `device`. Types are kept (float32/float64, int32, bool)."""
    device = resolve_device(device)
    unknown = set(fields) - set(BAProblem._fields)
    if unknown:
        raise ValueError(f"unknown BAProblem fields: {sorted(unknown)}")

    def conv(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(conv(e) for e in x)
        return torch.as_tensor(np.array(x, copy=True), device=device)

    return BAProblem(**{k: conv(v) for k, v in fields.items()})


def options_from_dict(d: dict) -> BAOptions:
    """dataclasses.asdict(jax BAOptions) -> the port's BAOptions."""
    d = dict(d)
    if "optimize_intrinsics" in d:
        d["optimize_intrinsics"] = tuple(bool(b) for b in
                                         d["optimize_intrinsics"])
    return BAOptions(**d)
