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

View graphs: `view_graph_from_state` takes the JAX ViewGraph's edges
as {(v1, v2): dataclasses.asdict(TwoViewInfo)} and builds the port's
ViewGraph; `two_view_info_from_state` copies one edge's payload.

Features: `features_db_from_arrays` takes the keypoints and descriptors
as the JAX package's database holds them (numpy arrays per image name)
and the intrinsics priors as plain field dicts, and builds the port's
in-memory features-and-matches database. `intrinsics_prior_from_state`
builds one prior from such a dict (`dataclasses.asdict` of a JAX
CameraIntrinsicsPrior, e.g. of those `read_calibration` returns).

Cascade hashing: `cascade_hasher_from_state` takes the JAX
CascadeHasher's projection basis (`np.asarray(hasher.proj)`, (D, 128))
and builds the port's hasher on it, so both hash alike.

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
from .sfm.view_graph import TwoViewInfo, ViewGraph
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
        db.put_intrinsics_prior(name, intrinsics_prior_from_state(fields))
    return db


def intrinsics_prior_from_state(fields: dict) -> CameraIntrinsicsPrior:
    """{CameraIntrinsicsPrior field: value} (e.g. `dataclasses.asdict` of
    a JAX prior, as `read_calibration` returns them) -> the port's prior
    (the model type as the port's enum, arrays copied)."""
    fields = dict(fields)
    if "camera_intrinsics_model_type" in fields:
        fields["camera_intrinsics_model_type"] = CameraModelType(
            int(fields["camera_intrinsics_model_type"]))
    for k in ("position", "orientation"):
        if fields.get(k) is not None:
            fields[k] = np.array(fields[k], dtype=np.float64, copy=True)
    return CameraIntrinsicsPrior(**fields)


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
        rec.views[vid] = View(
            name=v["name"], camera=Camera(**cam),
            prior=intrinsics_prior_from_state(v.get("prior") or {}),
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


def two_view_info_from_state(fields: dict) -> TwoViewInfo:
    """dataclasses.asdict(JAX TwoViewInfo) -> the port's TwoViewInfo
    (arrays copied as float64, counts as ints)."""
    f = dict(fields)
    for k in ("position_2", "rotation_2"):
        f[k] = np.array(f[k], dtype=np.float64, copy=True)
    for k in ("num_verified_matches", "num_homography_inliers",
              "visibility_score"):
        f[k] = int(f[k])
    for k in ("focal_length_1", "focal_length_2"):
        f[k] = float(f[k])
    return TwoViewInfo(**f)


def view_graph_from_state(edges: dict) -> ViewGraph:
    """{(v1, v2): dataclasses.asdict(TwoViewInfo)} of a JAX ViewGraph's
    edges (`graph.edges()`, stored with v1 < v2) -> the port's
    ViewGraph with the same edges and payloads."""
    graph = ViewGraph()
    for (v1, v2), info in edges.items():
        graph.add_edge(int(v1), int(v2), two_view_info_from_state(info))
    return graph


def cascade_hasher_from_state(proj, num_candidates: int = 10,
                              device="cuda"):
    """A JAX CascadeHasher's basis (numpy (D, 128)) -> the port's
    CascadeHasher on `device` with that basis."""
    from .matching.cascade_hasher import CascadeHasher
    proj = np.array(proj, np.float32)
    return CascadeHasher(proj.shape[0], num_candidates=num_candidates,
                         device=device, proj=proj)
