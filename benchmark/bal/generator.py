"""Seeded bundle-adjustment problems at a BAL problem's exact counts,
made on the device in a few large calls.

Frozen from theiasfm_tpu_torch/bench_problem.make_problem (which always
draws from seed 0, loops over cameras on the host and gives every point
the same number of observations) and from the perturbation of
scripts/bench_probe.py. Here everything is drawn from the run's seed:

* cameras on an arc of a ring (radius `ring_radius`, `ring_arc` of a
  turn) looking at its centre, their heights jittered;
* points uniform in a cube of half-width `cube_half`;
* each point's track length 2 plus its share of the remaining
  observations, each dealt to a point uniformly at random, so the counts
  are the published ones exactly and the mean track length theirs;
* each observation's camera uniform at random, distinct within a track
  (a BAL track sees a camera once);
* pixels projected through the truth with Gaussian noise of
  `pixel_noise` px per axis, and, where the traffic asks for them, gross
  outliers;
* the intrinsics groups the traffic names: one shared by every camera,
  or one per camera.

`start` draws a solve's perturbed starting state: each solve of a run
gets a fresh one from the seed and the solve's number.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import camera

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit generator seed for one stream of draws of a run: the same
    run seed and stream give the same seed, any whole number seed."""
    x = _splitmix64(seed & _MASK64)
    for part in stream:
        if isinstance(part, str):
            part = int.from_bytes(part.encode(), "little")
        x = _splitmix64(x ^ (part & _MASK64))
    return x >> 1


def generator(device, seed: int, *stream) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


@dataclasses.dataclass
class Scene:
    """One run's problem. The truth is float64; the observations and the
    intrinsics are what both sides are handed (float32 pixels)."""
    extrinsics: torch.Tensor    # (Nc, 6) float64 truth
    points: torch.Tensor        # (Np, 3) float64 truth
    intrinsics: torch.Tensor    # (Ng, 10) float32, the solves' start
    obs_cam: torch.Tensor       # (M,) int64, sorted by point then camera
    obs_group: torch.Tensor     # (M,) int64
    obs_pt: torch.Tensor        # (M,) int64, non-decreasing
    obs_pix: torch.Tensor       # (M, 2) float32
    obs_mask: torch.Tensor      # (M,) bool

    @property
    def counts(self):
        return (self.extrinsics.shape[0], self.points.shape[0],
                self.obs_cam.shape[0])


def group_count(groups, n_cams: int) -> int:
    if groups == "shared":
        return 1
    if groups == "per_camera":
        return n_cams
    raise ValueError("intrinsics_groups must be 'shared' or 'per_camera', "
                     f"got {groups!r}")


def _look_at_ring(n_cams, radius, arc, heights):
    """Cameras on the arc looking at the ring's centre: positions and
    world-to-camera angle-axis rotations, float64."""
    dev = heights.device
    ang = (2 * math.pi * arc / n_cams) * torch.arange(
        n_cams, dtype=torch.float64, device=dev)
    c = torch.stack([radius * torch.sin(ang), heights,
                     -radius * torch.cos(ang)], dim=-1)
    z = -c / torch.linalg.norm(c, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=dev)
    x = torch.linalg.cross(up.expand_as(z), z, dim=-1)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    R = torch.stack([x, y, z], dim=-2)                    # rows x, y, z
    # the logarithm of R: axis from the skew part, angle by atan2
    w = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], dim=-1) / 2
    s = torch.linalg.norm(w, dim=-1)
    cos = (R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1) / 2
    theta = torch.atan2(s, cos)
    scale = torch.where(s < 1e-12, torch.ones_like(s),
                        theta / s.clamp(min=1e-300))
    return torch.cat([c, w * scale[:, None]], dim=-1)


def _distinct_cameras(g, obs_pt, n_cams, rounds=64):
    """Uniform cameras for the observations, redrawn until no track sees a
    camera twice; returned sorted by (point, camera)."""
    cam = torch.randint(n_cams, obs_pt.shape, generator=g,
                        device=obs_pt.device)
    for _ in range(rounds):
        key, order = torch.sort(obs_pt * n_cams + cam, stable=True)
        cam = cam[order]
        dup = torch.zeros_like(key, dtype=torch.bool)
        dup[1:] = key[1:] == key[:-1]
        n = int(dup.sum())
        if n == 0:
            return cam
        cam[dup] = torch.randint(n_cams, (n,), generator=g,
                                 device=cam.device)
    raise RuntimeError("could not draw distinct cameras for every track")


def track_lengths(g, n_pts: int, n_obs: int):
    """(n_pts,) track lengths, each at least 2, summing to n_obs: 2 each,
    and every remaining observation dealt to a point uniformly at random."""
    if n_obs < 2 * n_pts:
        raise ValueError("fewer than two observations per point")
    extra = torch.randint(n_pts, (n_obs - 2 * n_pts,), generator=g,
                          device=g.device)
    return 2 + torch.bincount(extra, minlength=n_pts)


def make_scene(config: dict, traffic: dict, seed: int, device) -> Scene:
    """The run's cameras, points and observations at the configuration's
    counts, and its intrinsics grouping from the traffic."""
    n_cams, n_pts, n_obs = (int(config["cameras"]), int(config["points"]),
                            int(config["observations"]))
    sc = config["scene"]
    dev = torch.device(device)
    f64 = torch.float64
    g = generator(dev, seed, "scene")
    heights = sc["height_jitter"] * torch.randn(n_cams, generator=g,
                                                dtype=f64, device=dev)
    extr = _look_at_ring(n_cams, sc["ring_radius"], sc["ring_arc"], heights)
    half = sc["cube_half"]
    pts = (2 * torch.rand(n_pts, 3, generator=g, dtype=f64, device=dev) - 1
           ) * half

    lengths = track_lengths(g, n_pts, n_obs)
    obs_pt = torch.repeat_interleave(
        torch.arange(n_pts, device=dev), lengths, output_size=n_obs)
    obs_cam = _distinct_cameras(g, obs_pt, n_cams)

    n_groups = group_count(traffic["intrinsics_groups"], n_cams)
    obs_group = obs_cam if n_groups > 1 else torch.zeros_like(obs_cam)
    intr = torch.zeros(n_groups, 10, dtype=f64, device=dev)
    intr[:, 0] = sc["focal"]
    intr[:, 1] = 1.0
    intr[:, 3], intr[:, 4] = sc["principal_point"]

    pix, depth = camera.project(extr[obs_cam], intr[obs_group], pts[obs_pt])
    pix += sc["pixel_noise"] * torch.randn(pix.shape, generator=g, dtype=f64,
                                           device=dev)
    out = traffic.get("outliers")
    if out:
        hit = torch.rand(n_obs, generator=g, device=dev) < out["share"]
        shift = (2 * torch.rand(pix.shape, generator=g, dtype=f64,
                                device=dev) - 1) * out["pixels"]
        pix += shift * hit[:, None]
    return Scene(extrinsics=extr, points=pts,
                 intrinsics=intr.to(torch.float32),
                 obs_cam=obs_cam, obs_group=obs_group, obs_pt=obs_pt,
                 obs_pix=pix.to(torch.float32), obs_mask=depth > 0.1)


def start(scene: Scene, traffic: dict, seed: int, solve: int):
    """Solve `solve`'s starting extrinsics and points, float32: the truth
    plus each stage of noise the traffic lists (one Gaussian draw per
    stage and per value)."""
    dev = scene.extrinsics.device
    g = generator(dev, seed, "start", solve)
    noise = traffic["start_noise"]
    extr = scene.extrinsics.clone()
    pts = scene.points.clone()
    for pos, ang, pt in zip(noise["position"], noise["rotation"],
                            noise["point"]):
        e = torch.randn(extr.shape, generator=g, dtype=extr.dtype, device=dev)
        extr[:, :3] += pos * e[:, :3]
        extr[:, 3:] += ang * e[:, 3:]
        pts += pt * torch.randn(pts.shape, generator=g, dtype=pts.dtype,
                                device=dev)
    return extr.to(torch.float32), pts.to(torch.float32)
