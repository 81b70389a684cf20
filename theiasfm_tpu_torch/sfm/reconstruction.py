"""Host-side reconstruction data model (port of
theiasfm_tpu/sfm/reconstruction.py).

ref: src/theia/sfm/reconstruction.h:66-140 (Reconstruction container),
view.h (View), track.h (Track), camera/camera.h (Camera). The host side
is the system of record (dynamic insertion and removal, names, priors),
plain Python and numpy in float64; the device side is a fixed-shape
struct-of-tensors snapshot produced by `to_ba_problem` and folded back
with `update_from_ba`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..camera.models import MAX_INTRINSICS, CameraModelType
from ..utils.device import resolve_device
from .ba.bundle_adjustment import BAProblem
from .types import (CameraIntrinsicsGroupId, TrackId, ViewId,
                    kInvalidViewId)


@dataclasses.dataclass
class CameraIntrinsicsPrior:
    """ref: src/theia/sfm/camera_intrinsics_prior.h — optional per-view
    calibration priors (is_set flag per entry)."""
    image_width: int = 0
    image_height: int = 0
    focal_length: Optional[float] = None
    principal_point: Optional[Tuple[float, float]] = None
    aspect_ratio: Optional[float] = None
    skew: Optional[float] = None
    radial_distortion: Optional[Tuple[float, ...]] = None
    tangential_distortion: Optional[Tuple[float, float]] = None
    position: Optional[np.ndarray] = None
    orientation: Optional[np.ndarray] = None
    camera_intrinsics_model_type: CameraModelType = CameraModelType.PINHOLE


@dataclasses.dataclass
class Camera:
    """Extrinsics [position(3), angle-axis(3)] + padded intrinsics vector.
    ref: camera/camera.h:195-200 layout."""
    model_type: CameraModelType = CameraModelType.PINHOLE
    extrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(6))
    intrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: _default_intr())
    image_width: int = 0
    image_height: int = 0

    @property
    def position(self):
        return self.extrinsics[:3]

    @property
    def orientation(self):
        return self.extrinsics[3:6]

    @property
    def focal_length(self):
        return self.intrinsics[0]

    def set_from_prior(self, prior: CameraIntrinsicsPrior):
        """ref: sfm/set_camera_intrinsics_from_priors.cc semantics."""
        self.model_type = prior.camera_intrinsics_model_type
        self.image_width = prior.image_width or self.image_width
        self.image_height = prior.image_height or self.image_height
        if prior.focal_length:
            self.intrinsics[0] = prior.focal_length
        elif self.image_width and self.image_height:
            # ref default: 1.2 * max dimension
            # (feature_extractor_and_matcher.cc:269-275)
            self.intrinsics[0] = 1.2 * max(self.image_width,
                                           self.image_height)
        if prior.principal_point:
            self.intrinsics[3:5] = prior.principal_point
        elif self.image_width and self.image_height:
            self.intrinsics[3] = self.image_width / 2.0
            self.intrinsics[4] = self.image_height / 2.0
        if prior.aspect_ratio:
            self.intrinsics[1] = prior.aspect_ratio
        if prior.skew is not None:
            self.intrinsics[2] = prior.skew
        if prior.radial_distortion:
            rd = prior.radial_distortion
            if self.model_type == CameraModelType.PINHOLE:
                self.intrinsics[5:5 + min(2, len(rd))] = rd[:2]
            elif self.model_type == CameraModelType.PINHOLE_RADIAL_TANGENTIAL:
                self.intrinsics[5:5 + min(3, len(rd))] = rd[:3]
            elif self.model_type == CameraModelType.FISHEYE:
                self.intrinsics[5:5 + min(4, len(rd))] = rd[:4]
            else:
                self.intrinsics[5] = rd[0]


def _default_intr():
    p = np.zeros(MAX_INTRINSICS)
    p[0] = 1.0  # focal
    p[1] = 1.0  # aspect
    return p


@dataclasses.dataclass
class View:
    """ref: src/theia/sfm/view.h."""
    name: str
    camera: Camera = dataclasses.field(default_factory=Camera)
    prior: CameraIntrinsicsPrior = dataclasses.field(
        default_factory=CameraIntrinsicsPrior)
    is_estimated: bool = False
    features: Dict[TrackId, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def track_ids(self):
        return list(self.features.keys())


@dataclasses.dataclass
class Track:
    """ref: src/theia/sfm/track.h:65-69 (homogeneous point + color)."""
    point: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4))
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.uint8))
    is_estimated: bool = False
    views: Set[ViewId] = dataclasses.field(default_factory=set)

    def xyz(self):
        w = self.point[3]
        return self.point[:3] / (w if abs(w) > 1e-15 else 1e-15)


class Reconstruction:
    """ref: src/theia/sfm/reconstruction.h:66-140."""

    def __init__(self):
        self.views: Dict[ViewId, View] = {}
        self.tracks: Dict[TrackId, Track] = {}
        self._name_to_id: Dict[str, ViewId] = {}
        self._next_view_id: ViewId = 0
        self._next_track_id: TrackId = 0
        # view -> intrinsics group (shared intrinsics), ref
        # reconstruction.h CameraIntrinsicsGroupId APIs
        self.view_groups: Dict[ViewId, CameraIntrinsicsGroupId] = {}
        self._next_group_id: CameraIntrinsicsGroupId = 0

    # -- views ----------------------------------------------------------
    def add_view(self, name: str,
                 group: Optional[CameraIntrinsicsGroupId] = None) -> ViewId:
        if name in self._name_to_id:
            return kInvalidViewId
        vid = self._next_view_id
        self._next_view_id += 1
        self.views[vid] = View(name=name)
        self._name_to_id[name] = vid
        if group is None:
            group = self._next_group_id
            self._next_group_id += 1
        else:
            self._next_group_id = max(self._next_group_id, group + 1)
        self.view_groups[vid] = group
        return vid

    def remove_view(self, vid: ViewId) -> bool:
        view = self.views.pop(vid, None)
        if view is None:
            return False
        for tid in list(view.features.keys()):
            t = self.tracks.get(tid)
            if t is not None:
                t.views.discard(vid)
                if not t.views:
                    del self.tracks[tid]
        del self._name_to_id[view.name]
        self.view_groups.pop(vid, None)
        return True

    def view_id_from_name(self, name: str) -> ViewId:
        return self._name_to_id.get(name, kInvalidViewId)

    def view(self, vid: ViewId) -> Optional[View]:
        return self.views.get(vid)

    # -- tracks ---------------------------------------------------------
    def add_track(self) -> TrackId:
        tid = self._next_track_id
        self._next_track_id += 1
        self.tracks[tid] = Track()
        return tid

    def remove_track(self, tid: TrackId) -> bool:
        t = self.tracks.pop(tid, None)
        if t is None:
            return False
        for vid in t.views:
            v = self.views.get(vid)
            if v is not None:
                v.features.pop(tid, None)
        return True

    def track(self, tid: TrackId) -> Optional[Track]:
        return self.tracks.get(tid)

    def add_observation(self, vid: ViewId, tid: TrackId,
                        feature) -> bool:
        """ref: Reconstruction::AddObservation."""
        v = self.views[vid]
        if tid in v.features:
            return False
        v.features[tid] = np.asarray(feature, dtype=float)
        self.tracks[tid].views.add(vid)
        return True

    # -- queries --------------------------------------------------------
    def estimated_views(self):
        return [vid for vid, v in self.views.items() if v.is_estimated]

    def estimated_tracks(self):
        return [tid for tid, t in self.tracks.items() if t.is_estimated]

    def num_views(self):
        return len(self.views)

    def num_tracks(self):
        return len(self.tracks)

    # -- normalization --------------------------------------------------
    def normalize(self):
        """Center at median track position, scale so the median absolute
        deviation of points is 100 (ref Reconstruction::Normalize)."""
        pts = np.array([t.xyz() for t in self.tracks.values()
                        if t.is_estimated])
        if len(pts) == 0:
            return
        median = np.median(pts, axis=0)
        dist = np.linalg.norm(pts - median, axis=1)
        scale = 100.0 / max(np.median(dist), 1e-12)
        for t in self.tracks.values():
            if t.is_estimated:
                xyz = (t.xyz() - median) * scale
                t.point = np.append(xyz, 1.0)
        for v in self.views.values():
            if v.is_estimated:
                v.camera.extrinsics[:3] = (
                    v.camera.extrinsics[:3] - median) * scale

    # -- device snapshot -----------------------------------------------
    def to_ba_problem(self, dtype=torch.float32, only_estimated=True,
                      shared_intrinsics=True, track_subset=None,
                      device="cuda"):
        """Snapshot estimated views/tracks into a BAProblem on `device`.

        Returns (BAProblem, index_maps) where index_maps =
        (view_ids list, track_ids list, group_ids list, camera -> group
        index array).

        dtype is float32 by default, and an explicit argument: the JAX
        signature says float64, but there `jnp.asarray` yields float32
        wherever x64 is off, as it is on the TPU. A float64 snapshot here
        would make every reconstruction-level solve on the card float64,
        where the kernels are never eligible. Pass torch.float64 to
        compare with the JAX package under x64."""
        device = resolve_device(device)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        vids = (self.estimated_views() if only_estimated
                else sorted(self.views.keys()))
        tids = (self.estimated_tracks() if only_estimated
                else sorted(self.tracks.keys()))
        if track_subset is not None:
            tids = [t for t in tids if t in track_subset]
        vid_idx = {v: i for i, v in enumerate(vids)}
        tid_idx = {t: i for i, t in enumerate(tids)}
        if shared_intrinsics:
            groups = sorted({self.view_groups[v] for v in vids})
            grp_idx = {g: i for i, g in enumerate(groups)}
            cam_group = [grp_idx[self.view_groups[v]] for v in vids]
            intr = np.zeros((len(groups), MAX_INTRINSICS), np_dtype)
            for v in vids:
                intr[grp_idx[self.view_groups[v]]] = \
                    self.views[v].camera.intrinsics
        else:
            groups = list(vids)
            cam_group = list(range(len(vids)))
            intr = np.stack([self.views[v].camera.intrinsics
                             for v in vids]).astype(np_dtype)

        extr = np.stack([self.views[v].camera.extrinsics
                         for v in vids]).astype(np_dtype) if vids else \
            np.zeros((0, 6), np_dtype)
        pts = np.stack([self.tracks[t].xyz() for t in tids]).astype(
            np_dtype) if tids else np.zeros((0, 3), np_dtype)

        obs_cam, obs_pt, obs_pix = [], [], []
        for v in vids:
            for t, feat in self.views[v].features.items():
                if t in tid_idx:
                    obs_cam.append(vid_idx[v])
                    obs_pt.append(tid_idx[t])
                    obs_pix.append(feat)
        M = len(obs_cam)
        cam_group = np.asarray(cam_group, np.int32)
        obs_cam = np.asarray(obs_cam, np.int32)

        def t(x):
            return torch.as_tensor(x, device=device)

        prob = BAProblem(
            extrinsics=t(extr),
            intrinsics=t(intr),
            points=t(pts),
            obs_cam=t(obs_cam),
            obs_group=t(cam_group[obs_cam] if M
                        else np.zeros(0, np.int32)),
            obs_pt=t(np.asarray(obs_pt, np.int32)),
            obs_pix=t(np.stack(obs_pix).astype(np_dtype) if M
                      else np.zeros((0, 2), np_dtype)),
            obs_mask=torch.ones(M, dtype=torch.bool, device=device),
        )
        return prob, (vids, tids, groups, cam_group)

    def update_from_ba(self, prob, index_maps):
        """Fold an optimized BAProblem back into the host model (float64
        numpy, whatever the snapshot's type)."""
        vids, tids, groups, cam_group = index_maps

        def host(x):
            return x.detach().cpu().numpy().astype(np.float64)

        extr = host(prob.extrinsics)
        intr = host(prob.intrinsics)
        pts = host(prob.points)
        for i, v in enumerate(vids):
            self.views[v].camera.extrinsics = extr[i].copy()
            self.views[v].camera.intrinsics = intr[cam_group[i]].copy()
        for i, t in enumerate(tids):
            self.tracks[t].point = np.append(pts[i], 1.0)
