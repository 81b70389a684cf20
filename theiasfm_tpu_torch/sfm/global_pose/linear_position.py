"""Triplet-based linear position estimation (Jiang, Cui, Tan ICCV'13;
port of theiasfm_tpu/sfm/global_pose/linear_position.py).

ref: src/theia/sfm/global_pose_estimation/linear_position_estimator.{h,cc}
and compute_triplet_baseline_ratios.{h,cc}.

The reference walks triplets on a thread pool, triangulates common
tracks one by one, accumulates a sparse A^T A in a hash map and calls
Spectra's shift-invert eigensolver. Here every stage is batched on
`device` (the card unless the caller passes "cpu") in `dtype`:

- baseline ratios = batched midpoint triangulation over a (T, K) padded
  [triplet x common-track] grid, masked median over K;
- each triplet yields nine 3x3 constraint blocks (three "assume pair
  perfect" rows x three views); for the large path the Gram matrix
  A^T A is never formed: its matvec is gather + einsum + segment sum
  over the (T, 3) view-index table;
- smallest eigenvector: dense eigh of the Gram matrix (assembled from
  the blocks) for small systems, else CG-based inverse power iteration
  on the matrix-free operator from a random start drawn from a
  torch.Generator seeded with `seed` (JAX draws it from PRNGKey(seed):
  another start, the same eigenvector). The power loop reads its
  convergence test back once per power iteration (JAX's while_loop);
  the CG inside has no host sync.

The bearing vectors of the tracks are computed on the host in float64,
as the JAX module computes them in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...camera import models as cam_models
from ...math import rotation as rot
from ...math.graph import extract_triplets
from ...utils import linalg
from ...utils.device import full_f32, resolve_device
from .rotation_averaging import _host_rotations, _segment_sum


@dataclasses.dataclass(frozen=True)
class LinearPositionOptions:
    """ref: LinearPositionEstimator::Options
    (linear_position_estimator.h:63-73)."""
    max_power_iterations: int = 100
    eigensolver_threshold: float = 1e-8
    cg_iterations: int = 100
    max_tracks_per_triplet: int = 64
    # below this many free coordinates, form the dense Gram matrix + eigh
    dense_threshold: int = 1536
    min_triangulation_angle_degrees: float = 2.0


# ---------------------------------------------------------------------------
# baseline ratios


def _midpoint_depths(p2, d1, d2, min_angle_deg):
    """Depth of the midpoint-triangulated point from each camera.

    Rays: origin 0 along d1, origin p2 along d2 (all unit). Returns
    (depth1, depth2, valid). ref: GetTriangulatedPointDepths
    (compute_triplet_baseline_ratios.cc:55-87).
    """
    b = torch.sum(d1 * d2, dim=-1)
    denom = torch.clamp(1.0 - b * b, min=1e-12)
    wd1 = torch.sum(p2 * d1, dim=-1)
    wd2 = torch.sum(p2 * d2, dim=-1)
    s = (wd1 - wd2 * b) / denom
    t = s * b - wd2
    X = 0.5 * (s[..., None] * d1 + p2 + t[..., None] * d2)
    depth1 = torch.linalg.norm(X, dim=-1)
    depth2 = torch.linalg.norm(X - p2, dim=-1)
    cos_max = float(np.cos(np.deg2rad(min_angle_deg)))
    valid = (torch.abs(b) < cos_max) & (s > 0) & (t > 0)
    return depth1, depth2, valid


def _masked_median(vals, valid):
    """Median over the valid entries of the last axis (reference uses
    nth_element at n_valid/2 over the compacted list)."""
    v = torch.where(valid, vals, torch.full_like(vals, torch.inf))
    v = torch.sort(v, dim=-1).values
    n = torch.sum(valid, dim=-1)
    idx = torch.clamp(n // 2, 0, vals.shape[-1] - 1)
    return torch.gather(v, -1, idx[..., None])[..., 0]


def compute_triplet_baseline_ratios(R01, R02, R12, p01, p02, p12,
                                    f0, f1, f2, mask,
                                    min_angle_deg: float = 2.0):
    """Relative baseline lengths (b01=1, b02, b12) for a batch of view
    triplets from the depths of midpoint-triangulated common tracks.

    R??/p?? are relative rotations (T,3,3) / unit relative positions
    (T,3) of the second camera in the first camera's frame; f? are unit
    bearing vectors (T,K,3) in each camera's frame; mask (T,K) marks
    real (non-padded) tracks. Returns (baselines (T,3), valid (T,)), on
    the inputs' device. ref: ComputeTripletBaselineRatios
    (compute_triplet_baseline_ratios.cc:91-156).
    """
    def pair(p, R, fa, fb):
        db = fb @ R          # R^T fb, row-wise
        return _midpoint_depths(p[:, None, :], fa, db, min_angle_deg)

    d0_01, d1_01, v01 = pair(p01, R01, f0, f1)
    d0_02, d2_02, v02 = pair(p02, R02, f0, f2)
    d1_12, d2_12, v12 = pair(p12, R12, f1, f2)
    ok = mask & v01 & v02 & v12
    # same physical depth: d0_01 * b01 = d0_02 * b02  =>  b02 = d0_01/d0_02
    r02 = d0_01 / torch.clamp(d0_02, min=1e-12)
    r12 = d1_01 / torch.clamp(d1_12, min=1e-12)
    b02 = _masked_median(r02, ok)
    b12 = _masked_median(r12, ok)
    valid = torch.sum(ok, dim=-1) > 0
    ones = torch.ones_like(b02)
    baselines = torch.stack([ones, torch.where(valid, b02, ones),
                             torch.where(valid, b12, ones)], dim=-1)
    return baselines, valid


# ---------------------------------------------------------------------------
# constraint blocks


def _rotation_between(a, b):
    """Minimal rotation R with R a = b (unit vectors), batched; the
    Eigen::Quaterniond::FromTwoVectors of the reference
    (linear_position_estimator.cc:357-360)."""
    c = torch.linalg.cross(a, b, dim=-1)
    d = torch.sum(a * b, dim=-1)
    K = rot.skew(c)
    s2 = torch.sum(c * c, dim=-1)
    fac = torch.where(s2 > 1e-14, (1.0 - d) / torch.clamp(s2, min=1e-30),
                      torch.full_like(s2, 0.5))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    R = eye + K + fac[..., None, None] * (K @ K)
    # antiparallel fallback: rotation by pi about any axis orthogonal to a
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    helper = torch.where(torch.abs(a[..., :1]) < 0.9, ex.expand(a.shape),
                         ey.expand(a.shape))
    v = torch.linalg.cross(a, helper, dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    R_pi = 2.0 * v[..., :, None] * v[..., None, :] - eye
    anti = (d < -1.0 + 1e-8)[..., None, None]
    return torch.where(anti, R_pi, R)


def _triplet_constraint_blocks(t01, t02, t12, baselines, w):
    """Per-triplet constraint rows of the linear system A.

    t?? (T,3): world-frame unit directions c_j - c_i; baselines (T,3);
    w (T,): per-triplet weight. Returns (T, 3, 3, 3, 3) =
    [constraint, view-slot, 3x3 block].
    ref: AddTripletConstraintToSparseMatrix
    (linear_position_estimator.cc:363-422).
    """
    r012 = _rotation_between(t12, -t01)
    r201 = _rotation_between(t01, t02)
    r120 = _rotation_between(-t02, -t12)
    s012 = baselines[:, 0] / baselines[:, 2]
    s201 = baselines[:, 1] / baselines[:, 0]
    s120 = baselines[:, 2] / baselines[:, 1]
    eye = torch.eye(3, dtype=t01.dtype, device=t01.device)
    m2 = (-2.0 * eye).expand(r012.shape)

    def m(s):
        return s[:, None, None]

    r012T = r012.transpose(-1, -2)
    r201T = r201.transpose(-1, -2)
    r120T = r120.transpose(-1, -2)
    # assume t01 perfect, solve for c2
    c0 = torch.stack([-m(s201) * r201 + r012T / m(s012) + eye,
                      m(s201) * r201 - r012T / m(s012) + eye, m2], dim=1)
    # assume t02 perfect, solve for c1
    c1 = torch.stack([-r201T / m(s201) + m(s120) * r120 + eye, m2,
                      r201T / m(s201) - m(s120) * r120 + eye], dim=1)
    # assume t12 perfect, solve for c0
    c2 = torch.stack([m2, -m(s012) * r012 + r120T / m(s120) + eye,
                      m(s012) * r012 - r120T / m(s120) + eye], dim=1)
    blocks = torch.stack([c0, c1, c2], dim=1)  # (T, constraint, view, 3, 3)
    return blocks * w[:, None, None, None, None]


def _make_matvec(blocks, tri_idx, num_views):
    """Matrix-free y = P A^T A P x with camera 0 pinned (P zeros its
    coords and the identity is restored there so the operator stays
    positive definite)."""
    flat_idx = tri_idx.reshape(-1)  # (T*3,)

    def matvec(x):
        x0 = x[0]
        x = torch.cat([torch.zeros_like(x[:1]), x[1:]])
        xg = x[tri_idx]                                  # (T, 3, 3)
        r = torch.einsum("tcvij,tvj->tci", blocks, xg)   # rows of A x
        contrib = torch.einsum("tcvij,tci->tvj", blocks, r)
        y = _segment_sum(contrib.reshape(-1, 3), flat_idx, num_views)
        return torch.cat([x0[None], y[1:]])

    return matvec


def _smallest_eigvec_inverse_power(blocks, tri_idx, num_views: int,
                                   iters: int, cg_iters: int, tol: float,
                                   seed: int = 0):
    """Inverse power iteration with matrix-free CG solves; replaces the
    reference's Spectra shift-invert LLT (linear_position_estimator.cc:
    199-206)."""
    matvec = _make_matvec(blocks, tri_idx, num_views)
    # tiny Tikhonov shift keeps CG happy when the smallest eig ~ 0
    mu = 1e-8

    def op(x):
        return matvec(x) + mu * x

    def cg_solve(b, x0):
        x = x0
        r = b - op(x0.reshape(-1, 3)).reshape(-1)
        p = r
        rs = torch.dot(r, r)
        for _ in range(cg_iters):
            Ap = op(p.reshape(-1, 3)).reshape(-1)
            alpha = rs / torch.clamp(torch.dot(p, Ap), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
            rs = rs_new
        return x

    gen = torch.Generator(blocks.device).manual_seed(seed)
    v = torch.randn(num_views * 3, generator=gen, dtype=blocks.dtype,
                    device=blocks.device)
    v[:3] = 0.0
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        z = cg_solve(v, v)
        z = torch.cat([z.new_zeros(3), z[3:]])
        z = z / torch.clamp(torch.linalg.norm(z), min=1e-30)
        delta = torch.minimum(torch.linalg.norm(z - v),
                              torch.linalg.norm(z + v))
        v = z
        if float(delta) <= tol:   # one read-back per power iteration
            break
    return v.reshape(-1, 3)


def _smallest_eigvec_dense(blocks, tri_idx, num_views: int):
    """Dense path: assemble the Gram matrix A^T A from the blocks, drop
    the pinned camera 0, then eigh (small systems)."""
    T = tri_idx.shape[0]
    G = blocks.new_zeros((num_views, num_views, 3, 3))
    g = torch.einsum("tcvij,tcwik->tvwjk", blocks, blocks)   # (T,3,3,3,3)
    a = tri_idx[:, :, None].expand(T, 3, 3).reshape(-1)
    b = tri_idx[:, None, :].expand(T, 3, 3).reshape(-1)
    G.index_put_((a, b), g.reshape(-1, 3, 3), accumulate=True)
    M = G.permute(0, 2, 1, 3).reshape(3 * num_views, 3 * num_views)
    Mf = M[3:, 3:]
    _, vecs = linalg.eigh(0.5 * (Mf + Mf.T))
    sol = vecs[:, 0]
    return torch.cat([sol.new_zeros((1, 3)), sol.reshape(-1, 3)], dim=0)


def _fix_sign(positions, edge_i, edge_j, t_world):
    """Flip the global sign if the majority of estimated baselines point
    against the measured relative translations.
    ref: FlipSignOfPositionsIfNecessary
    (linear_position_estimator.cc:139-153,424-448)."""
    d = positions[edge_j] - positions[edge_i]
    agree = torch.sum(torch.sign(torch.sum(d * t_world, dim=-1)))
    return torch.where(agree < 0, -positions, positions)


# ---------------------------------------------------------------------------
# host side


def _normalized_rays_for_view(view, track_ids: Sequence[int]):
    """Unit bearing vectors in the camera frame for the given tracks
    (host, float64)."""
    px = np.stack([view.features[t] for t in track_ids])
    xy = cam_models.pixel_to_normalized_ray(
        view.camera.model_type,
        torch.from_numpy(np.asarray(view.camera.intrinsics, np.float64)),
        torch.from_numpy(np.asarray(px, np.float64))).numpy()
    f = np.concatenate([xy, np.ones_like(xy[:, :1])], axis=1)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


@full_f32()
def estimate_positions_linear_triplet(
        recon, vids: List[int], orientations: np.ndarray,
        edges: np.ndarray, rel_positions: np.ndarray,
        opts: LinearPositionOptions = LinearPositionOptions(),
        rel_rotations: np.ndarray = None, dtype=torch.float32,
        device="cuda"):
    """Estimate camera positions from view triplets (LINEAR_TRIPLET).

    vids: view ids aligned with `orientations` rows; edges (E,2) indexes
    into vids; rel_positions (E,3) = TwoViewInfo.position_2. Returns
    (positions (V,3), covered_mask (V,)) -- views outside the triplet
    graph get no position (reference only fills views in the linear
    system, linear_position_estimator.cc:209-218).
    """
    dev = resolve_device(device)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    V = len(vids)
    positions = np.zeros((V, 3))
    covered = np.zeros(V, dtype=bool)
    edge_map: Dict[Tuple[int, int], int] = {}
    for e, (i, j) in enumerate(np.asarray(edges)):
        edge_map[(int(i), int(j))] = e
        edge_map[(int(j), int(i))] = e
    triplets = extract_triplets([tuple(e) for e in np.asarray(edges)])
    if not triplets:
        return positions, covered

    # world-frame direction c_j - c_i for every edge
    R_all = _host_rotations(orientations)
    R_i = R_all[np.asarray(edges)[:, 0]]
    t_world = np.einsum("eji,ej->ei", R_i, np.asarray(rel_positions))
    t_world /= np.maximum(
        np.linalg.norm(t_world, axis=-1, keepdims=True), 1e-12)

    K = opts.max_tracks_per_triplet
    ray_cache: Dict[int, Dict[int, np.ndarray]] = {}

    def rays(vidx, tids):
        if vidx not in ray_cache:
            ray_cache[vidx] = {}
        cache = ray_cache[vidx]
        missing = [t for t in tids if t not in cache]
        if missing:
            f = _normalized_rays_for_view(recon.views[vids[vidx]], missing)
            for t_, fv in zip(missing, f):
                cache[t_] = fv
        return np.stack([cache[t_] for t_ in tids])

    T = len(triplets)
    tri_idx = np.asarray(triplets, dtype=np.int64)
    f0 = np.zeros((T, K, 3))
    f1 = np.zeros((T, K, 3))
    f2 = np.zeros((T, K, 3))
    f0[..., 2] = f1[..., 2] = f2[..., 2] = 1.0
    mask = np.zeros((T, K), dtype=bool)
    e01 = np.array([edge_map[(a, b)] for a, b, _ in triplets])
    e02 = np.array([edge_map[(a, c)] for a, _, c in triplets])
    e12 = np.array([edge_map[(b, c)] for _, b, c in triplets])
    for ti, (a, b, c) in enumerate(triplets):
        va, vb, vc = (recon.views[vids[a]], recon.views[vids[b]],
                      recon.views[vids[c]])
        common = sorted(set(va.features) & set(vb.features)
                        & set(vc.features))
        if len(common) > K:
            sel = np.linspace(0, len(common) - 1, K).astype(int)
            common = [common[s] for s in sel]
        if not common:
            continue
        n = len(common)
        f0[ti, :n] = rays(a, common)
        f1[ti, :n] = rays(b, common)
        f2[ti, :n] = rays(c, common)
        mask[ti, :n] = True

    def rel_R(e, i_first):
        # relative rotation of edge e oriented so `i_first` is the
        # first camera: R_rel = R_second R_first^T
        ei, ej = int(edges[e][0]), int(edges[e][1])
        Ri, Rj = R_all[ei], R_all[ej]
        return (Rj @ Ri.T) if ei == i_first else (Ri @ Rj.T)

    def rel_p(e, i_first, other):
        # unit position of `other` in `i_first`'s camera frame
        d = t_world[e] if int(edges[e][0]) == i_first else -t_world[e]
        return R_all[i_first] @ d

    R01 = np.stack([rel_R(e, a) for e, (a, _, _) in zip(e01, triplets)])
    R02 = np.stack([rel_R(e, a) for e, (a, _, _) in zip(e02, triplets)])
    R12 = np.stack([rel_R(e, b) for e, (_, b, _) in zip(e12, triplets)])
    p01 = np.stack([rel_p(e, a, b) for e, (a, b, _) in zip(e01, triplets)])
    p02 = np.stack([rel_p(e, a, c) for e, (a, _, c) in zip(e02, triplets)])
    p12 = np.stack([rel_p(e, b, c) for e, (_, b, c) in zip(e12, triplets)])

    baselines, valid = compute_triplet_baseline_ratios(
        t(R01), t(R02), t(R12), t(p01), t(p02), t(p12), t(f0), t(f1),
        t(f2), t(mask, torch.bool),
        min_angle_deg=opts.min_triangulation_angle_degrees)
    baselines = baselines.cpu().numpy().astype(np.float64)
    valid = valid.cpu().numpy()
    if not valid.any():
        return positions, covered
    tri_idx = tri_idx[valid]
    baselines = baselines[valid]
    t01 = t_world[e01[valid]]
    t02 = t_world[e02[valid]]
    t12 = t_world[e12[valid]]

    # compact to the views that participate in >= 1 triplet, view 0 of
    # the compact numbering is pinned at the origin
    used = np.unique(tri_idx.reshape(-1))
    remap = -np.ones(V, dtype=np.int64)
    remap[used] = np.arange(len(used))
    tri_c = remap[tri_idx]
    counts = np.bincount(tri_c.reshape(-1), minlength=len(used))
    w = 1.0 / np.sqrt(np.minimum.reduce(
        [counts[tri_c[:, 0]], counts[tri_c[:, 1]], counts[tri_c[:, 2]]]))

    blocks = _triplet_constraint_blocks(t(t01), t(t02), t(t12),
                                        t(baselines), t(w))
    nu = len(used)
    tri_t = t(tri_c, torch.int64)
    if 3 * nu <= opts.dense_threshold:
        sol = _smallest_eigvec_dense(blocks, tri_t, nu)
    else:
        sol = _smallest_eigvec_inverse_power(
            blocks, tri_t, nu, iters=opts.max_power_iterations,
            cg_iters=opts.cg_iterations, tol=opts.eigensolver_threshold)

    # sign fix against the measured directions on covered edges
    E_all = np.asarray(edges)
    cov_e = np.array([e for e, (i, j) in enumerate(E_all)
                      if remap[int(i)] >= 0 and remap[int(j)] >= 0])
    sol = _fix_sign(sol, t(remap[E_all[cov_e, 0]], torch.int64),
                    t(remap[E_all[cov_e, 1]], torch.int64),
                    t(t_world[cov_e]))
    sol = sol.cpu().numpy().astype(np.float64)
    positions[used] = sol
    covered[used] = True
    # unit mean baseline (gauge freedom; keeps downstream thresholds sane)
    if len(cov_e):
        d = positions[E_all[cov_e, 1]] - positions[E_all[cov_e, 0]]
        scale = np.mean(np.linalg.norm(d, axis=-1))
        if scale > 1e-12:
            positions[used] /= scale
    return positions, covered
