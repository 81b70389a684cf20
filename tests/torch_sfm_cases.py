"""Inputs shared by the incremental-slice tests (tests/test_torch_*.py of
tracks, localization, filters, the pipeline and the builder): the
synthetic scene of tests/test_incremental_pipeline.py (cameras on an
arc around a point cloud, 8 views, 150 points, 0.3 px noise) made with
numpy alone, the same reconstruction in both packages, a view graph
from the true relative poses, and the sample indices JAX's localization
draws from a key; a fixture that runs a module's torch ops on one
thread."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theiasfm_tpu.math import rotation as jrot
from theiasfm_tpu.sfm.reconstruction import Reconstruction as JRecon
from theiasfm_tpu.sfm.track_builder import TrackBuilder as JTrackBuilder
from theiasfm_tpu.solvers.ransac import random_samples as jrs
from theiasfm_tpu.sfm.view_graph import TwoViewInfo as JTwoViewInfo
from theiasfm_tpu_torch import convert
from theiasfm_tpu_torch.sfm.reconstruction import Reconstruction as TRecon
from theiasfm_tpu_torch.sfm.track_builder import TrackBuilder as TTrackBuilder

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one thread: the port's small
    tensors gain nothing from more, and the parallel test run's workers
    would otherwise oversubscribe the cores (the whole-pipeline tests ran
    2-10 times slower beside other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FOCAL = 700.0
PP = (500.0, 400.0)
SIZE = (1000, 800)


def rotation(aa):
    return np.asarray(jrot.angle_axis_to_rotation_matrix(
        jnp.asarray(np.asarray(aa, np.float64))))


def angle_axis(R):
    return np.asarray(jrot.rotation_matrix_to_angle_axis(jnp.asarray(R)))


@dataclasses.dataclass
class Scene:
    extrinsics: np.ndarray   # (V, 6) true [position, angle-axis]
    points: np.ndarray       # (P, 3)
    obs: dict                # (view, point) -> noisy pixel (2,)

    @property
    def n_views(self):
        return len(self.extrinsics)


def scene(rng, n_views=8, n_pts=150, noise=0.3):
    """test_incremental_pipeline.build_synthetic_scene's geometry and
    observations, in numpy."""
    extrs = []
    for v in range(n_views):
        ang = 0.9 * (v / (n_views - 1) - 0.5)
        c = np.array([8 * np.sin(ang), 0.4 * rng.normal(),
                      -8 * np.cos(ang)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        extrs.append(np.concatenate([c, angle_axis(np.stack([x, y, z]))]))
    extrs = np.stack(extrs)
    pts = rng.uniform(-2.5, 2.5, size=(n_pts, 3))
    obs = {}
    for v in range(n_views):
        pc = (pts - extrs[v, :3]) @ rotation(extrs[v, 3:]).T
        pix = FOCAL * pc[:, :2] / pc[:, 2:] + PP
        pix = pix + rng.normal(scale=noise, size=pix.shape)
        for p in range(n_pts):
            if pc[p, 2] > 0.5 and 0 <= pix[p, 0] < SIZE[0] and \
                    0 <= pix[p, 1] < SIZE[1]:
                obs[(v, p)] = pix[p]
    return Scene(extrs, pts, obs)


def intrinsics():
    intr = np.zeros(10)
    intr[0], intr[1], intr[3], intr[4] = FOCAL, 1.0, PP[0], PP[1]
    return intr


def correspondences(sc: Scene, v1, v2):
    """(K, 4) [x1 y1 x2 y2] of the points both views observe."""
    return np.array([np.concatenate([sc.obs[(v1, p)], sc.obs[(v2, p)]])
                     for p in range(len(sc.points))
                     if (v1, p) in sc.obs and (v2, p) in sc.obs]
                    ).reshape(-1, 4)


def reconstructions(sc: Scene):
    """The scene's views (shared intrinsics group 0) and its tracks from
    all pairwise correspondences, built by each package's own
    TrackBuilder: (JAX Reconstruction, port Reconstruction)."""
    out = []
    for Recon, TB in ((JRecon, JTrackBuilder), (TRecon, TTrackBuilder)):
        rec = Recon()
        for v in range(sc.n_views):
            vid = rec.add_view(f"img{v}.jpg", group=0)
            cam = rec.view(vid).camera
            cam.intrinsics = intrinsics()
            cam.image_width, cam.image_height = SIZE
        tb = TB(min_track_length=2)
        for v1 in range(sc.n_views):
            for v2 in range(v1 + 1, sc.n_views):
                for row in correspondences(sc, v1, v2):
                    tb.add_feature_correspondence(v1, row[:2], v2, row[2:])
        tb.build_tracks(rec)
        out.append(rec)
    return tuple(out)


def true_info(sc: Scene, v1, v2, num_verified):
    """TwoViewInfo fields of camera v2 relative to camera v1 (unit
    baseline) from the true poses."""
    R1, R2 = rotation(sc.extrinsics[v1, 3:]), rotation(sc.extrinsics[v2, 3:])
    pos = R1 @ (sc.extrinsics[v2, :3] - sc.extrinsics[v1, :3])
    return dict(focal_length_1=FOCAL, focal_length_2=FOCAL,
                position_2=pos / np.linalg.norm(pos),
                rotation_2=angle_axis(R2 @ R1.T),
                num_verified_matches=int(num_verified),
                num_homography_inliers=0, visibility_score=0)


def graph_edges(sc: Scene, min_matches=30):
    """{(v1, v2): TwoViewInfo fields} for the pairs with >= min_matches
    common points."""
    edges = {}
    for v1 in range(sc.n_views):
        for v2 in range(v1 + 1, sc.n_views):
            n = len(correspondences(sc, v1, v2))
            if n >= min_matches:
                edges[(v1, v2)] = true_info(sc, v1, v2, n)
    return edges


def graphs(edges):
    """(JAX ViewGraph, port ViewGraph) of the same edges."""
    from theiasfm_tpu.sfm.view_graph import ViewGraph as JViewGraph
    jg = JViewGraph()
    for (v1, v2), f in edges.items():
        jg.add_edge(v1, v2, JTwoViewInfo(**f))
    return jg, convert.view_graph_from_state(edges)


def set_true_state(sc: Scene, rec, views=None):
    """Estimate `views` (all by default) at their true poses and every
    track at its true point (tracks found by their first observation)."""
    views = range(sc.n_views) if views is None else views
    for v in views:
        rec.views[v].camera.extrinsics = sc.extrinsics[v].copy()
        rec.views[v].is_estimated = True
    for t, tr in rec.tracks.items():
        v = min(tr.views)
        feat = rec.views[v].features[t]
        p = next(p for p in range(len(sc.points))
                 if (v, p) in sc.obs and np.array_equal(sc.obs[(v, p)], feat))
        tr.point = np.append(sc.points[p], 1.0)
        tr.is_estimated = True


def jax_localize_samples(key, batch, num_hypotheses):
    """The (V, H, 3) indices JAX's localize_views_batch draws from `key`
    for a prepared batch (theiasfm_tpu_torch's LocalizeBatch)."""
    V, N = batch.mask.shape
    keys = jax.random.split(key, V)
    return torch.from_numpy(np.stack([
        np.array(jrs(keys[i], N, 3, num_hypotheses,
                     jnp.asarray(batch.mask[i]))) for i in range(V)]))

