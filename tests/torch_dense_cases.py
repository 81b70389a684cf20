"""Problems for the dense Schur solver's correction build: the pair layout
(sfm/ba/dense_corr.py), its plain segment sums and the CUDA kernels of
csrc/dense_corr.cu, against bundle_adjustment._dense_schur_corr.

numpy-seeded ids and jacobians, no JAX: the card's tests import it too.
A case names how groups follow cameras and what the observations hold:

* groups "one" (Ng = 1), "per_camera" (Ng = Nc, group = camera), "shared"
  (each group held by several cameras, not adjacent ones), "spanning"
  (one camera's observations name two groups);
* masked and padded observations (pad_obs_to_multiple), the masked ones'
  jacobians zero as the solver's weights make them;
* points seen once (only the pair k == l);
* `long`: cameras 0 and 1 share `long` points, so their camera pair's
  segment runs over many chunks."""
from __future__ import annotations

import numpy as np
import torch

from theiasfm_tpu_torch.sfm.ba import bundle_adjustment as ba

N_CAMS = 40          # more than one tile of the camera-pair order


def groups_of(cams, kind, n_cams):
    """(each camera's group, Ng) for a kind of grouping."""
    if kind == "one":
        return np.zeros_like(cams), 1
    if kind == "per_camera":
        return cams.copy(), n_cams
    n_groups = 6
    return (cams * 5) % n_groups, n_groups


def problem(seed, groups="per_camera", P=3, dtype=torch.float64,
            device="cpu", n_cams=N_CAMS, n_pts=300, long=0, masked=True):
    """(BAProblem with pt_idx_map, Jc12, JiP, Jp6, Hpp_inv): track lengths
    1-6 over distinct cameras, and `long` more points seen by cameras 0
    and 1 only."""
    rng = np.random.default_rng(seed)
    cams, pts = [], []
    for p in range(n_pts):
        t = int(rng.integers(1, min(7, n_cams + 1)))
        cams.append(rng.choice(n_cams, size=t, replace=False))
        pts.append(np.full(t, p))
    for p in range(n_pts, n_pts + long):
        cams.append(np.array([0, 1]))
        pts.append(np.full(2, p))
    obs_cam = np.concatenate(cams)
    obs_pt = np.concatenate(pts)
    M, Np = obs_cam.shape[0], n_pts + long
    grp, Ng = groups_of(obs_cam, "one" if groups == "spanning" else groups,
                        n_cams)
    if groups == "spanning":
        Ng = 2
        first = np.flatnonzero(obs_cam == 3)[0]
        grp[first] = 1
    mask = np.ones(M, bool)
    if masked:
        mask[rng.random(M) < 0.1] = False

    def t(x, dt=torch.float64):
        return torch.as_tensor(x, device=device).to(dt)

    prob = ba.BAProblem(
        extrinsics=torch.zeros((n_cams, 6), dtype=dtype, device=device),
        intrinsics=torch.zeros((Ng, 10), dtype=dtype, device=device),
        points=torch.zeros((Np, 3), dtype=dtype, device=device),
        obs_cam=t(obs_cam, torch.int32), obs_group=t(grp, torch.int32),
        obs_pt=t(obs_pt, torch.int32),
        obs_pix=torch.zeros((M, 2), dtype=dtype, device=device),
        obs_mask=t(mask, torch.bool))
    if masked:
        prob = ba.pad_obs_to_multiple(prob, 64)
    prob = ba.add_point_obs_map(prob)
    M = prob.obs_cam.shape[0]
    w = prob.obs_mask.cpu().numpy()[:, None].astype(np.float64)
    Jc12 = t(rng.normal(size=(M, 12)) * w, dtype)
    JiP = t(rng.normal(size=(M, 2 * P)) * w, dtype)
    Jp6 = t(rng.normal(size=(M, 6)) * w, dtype)
    Jp3 = Jp6.reshape(M, 2, 3)
    Hpp9 = torch.zeros((Np, 9), dtype=dtype, device=device).index_add_(
        0, prob.obs_pt.long(),
        torch.einsum("mka,mkb->mab", Jp3, Jp3).reshape(M, 9))
    Hpp_inv = ba._inv3_flat(Hpp9 * 1.01, eps_diag=1e-3)
    return prob, Jc12, JiP, Jp6, Hpp_inv


def plain(prob, Jc12, JiP, Jp6, Hpp_inv):
    """_dense_schur_corr over the problem's pairs."""
    return ba._dense_schur_corr(prob, Jc12, JiP, Jp6, Hpp_inv,
                                ba._point_obs_pairs(prob))
