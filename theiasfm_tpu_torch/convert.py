"""Hand state of the JAX package over to the port.

Bundle adjustment: the caller converts the JAX BAProblem's fields to
numpy arrays (a dict of field name -> np.ndarray or None, e.g.
`{k: None if v is None else np.asarray(v) for k, v in p._asdict().items()}`)
and its BAOptions to a dict (`dataclasses.asdict`); this module turns
them into the port's BAProblem and BAOptions.

Reconstructions: `reconstruction_from_state` takes the JAX
Reconstruction's views, tracks and intrinsics groups as plain dicts of
numpy arrays and scalars (`dataclasses.asdict` of each View and Track)
and builds the port's Reconstruction.

Features: `features_db_from_arrays` takes the keypoints and descriptors
as the JAX package's database holds them (numpy arrays per image name)
and the intrinsics priors as plain field dicts, and builds the port's
in-memory features-and-matches database.

Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .camera.models import CameraModelType
from .matching.database import (InMemoryFeaturesAndMatchesDatabase,
                                KeypointsAndDescriptors)
from .sfm.ba.bundle_adjustment import BAOptions, BAProblem
from .sfm.reconstruction import (Camera, CameraIntrinsicsPrior,
                                 Reconstruction, Track, View)
from .utils.device import resolve_device


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


def features_db_from_arrays(features: dict, priors: dict = None
                            ) -> InMemoryFeaturesAndMatchesDatabase:
    """{name: (keypoints (K, 4), descriptors (K, D))} numpy arrays, and
    optionally {name: {CameraIntrinsicsPrior field: value}}, -> the
    port's in-memory database holding them (arrays copied)."""
    db = InMemoryFeaturesAndMatchesDatabase()
    for name, (kps, desc) in features.items():
        db.put_features(name, KeypointsAndDescriptors(
            image_name=name, keypoints=np.array(kps, copy=True),
            descriptors=np.array(desc, copy=True)))
    for name, fields in (priors or {}).items():
        fields = dict(fields)
        if "camera_intrinsics_model_type" in fields:
            fields["camera_intrinsics_model_type"] = CameraModelType(
                int(fields["camera_intrinsics_model_type"]))
        db.put_intrinsics_prior(name, CameraIntrinsicsPrior(**fields))
    return db


def reconstruction_from_state(state: dict) -> Reconstruction:
    """A JAX Reconstruction's state -> the port's Reconstruction (arrays
    copied). `state` holds
      "views": {view id: dataclasses.asdict(View)},
      "tracks": {track id: dataclasses.asdict(Track)},
      "view_groups": {view id: intrinsics group id},
    and optionally "next_view_id", "next_track_id", "next_group_id" (by
    default one past the largest id in use)."""
    rec = Reconstruction()

    def model(x):
        return CameraModelType(int(x))

    for vid, v in state["views"].items():
        cam = dict(v["camera"])
        cam["model_type"] = model(cam["model_type"])
        for k in ("extrinsics", "intrinsics"):
            cam[k] = np.array(cam[k], dtype=np.float64, copy=True)
        prior = dict(v.get("prior") or {})
        if "camera_intrinsics_model_type" in prior:
            prior["camera_intrinsics_model_type"] = model(
                prior["camera_intrinsics_model_type"])
        rec.views[vid] = View(
            name=v["name"], camera=Camera(**cam),
            prior=CameraIntrinsicsPrior(**prior),
            is_estimated=bool(v["is_estimated"]),
            features={t: np.array(f, dtype=float, copy=True)
                      for t, f in v["features"].items()})
        rec._name_to_id[v["name"]] = vid
    for tid, t in state["tracks"].items():
        rec.tracks[tid] = Track(
            point=np.array(t["point"], dtype=np.float64, copy=True),
            color=np.array(t["color"], copy=True),
            is_estimated=bool(t["is_estimated"]), views=set(t["views"]))
    rec.view_groups = dict(state["view_groups"])
    rec._next_view_id = state.get("next_view_id",
                                  max(rec.views, default=-1) + 1)
    rec._next_track_id = state.get("next_track_id",
                                   max(rec.tracks, default=-1) + 1)
    rec._next_group_id = state.get(
        "next_group_id", max(rec.view_groups.values(), default=-1) + 1)
    return rec
