"""AKAZE features in PyTorch (port of theiasfm_tpu/image/akaze.py):
nonlinear diffusion scale space, Hessian-determinant detector, M-SURF
descriptor.

ref: src/theia/image/descriptor/akaze_descriptor.cc (wraps the vendored
libAKAZE with MSURF float descriptors, :82-85) and the AKAZE paper
(Alcantarilla et al., BMVC 2013). The JAX module's fixed-shape
formulation, step for step:

  * the nonlinear (Perona-Malik G2) diffusion runs one FED cycle of
    explicit steps per evolution level (conductivity recomputed at
    every step); the steps are an eager loop on the device,
  * the contrast factor k is the 70th percentile of the base image's
    gradient magnitude (torch.quantile, linear interpolation as
    jnp.percentile),
  * detection = scale-normalized det(Hessian) maxima over space and
    adjacent levels (max_pool3d pads with -inf, as JAX's reduce_window
    with a -inf init) with a static keypoint budget per octave,
  * descriptors = M-SURF 64-d: 4x4 overlapping cells of Gaussian-
    weighted (sum dx, sum dy, sum |dx|, sum |dy|) in the keypoint's
    rotated frame, sampled bilinearly by gathers.

It has no kernel of its own: every step is plain PyTorch. The entry
point runs under `utils.device.full_f32` (cuDNN would run the Scharr
convolutions in TF32), on `device` (the card by default; it raises
without one).

Three details keep JAX's results: gradients wrap around (torch.roll, as
jnp.roll); the keypoint budget is taken by a stable descending sort of
the scores, so equal scores (every invalid slot scores 0) come out in
ascending flat index as jax.lax.top_k gives them (torch.topk orders
ties arbitrarily); and the Scharr convolutions are cross-correlations on
an edge-padded image (F.pad "replicate"), as conv_general_dilated on
jnp.pad "edge". The FED cycle's single steps exceed the stability
limit, so float32 rounding inside a cycle grows: on the card and on the
CPU a keypoint near the threshold may appear on one side only, and the
tests compare keypoint sets rather than arrays.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import full_f32, resolve_device
from .sift import _blur, _keypoint_orientation_maps


@dataclasses.dataclass(frozen=True)
class AkazeOptions:
    num_octaves: int = 4
    sublevels: int = 4
    detector_threshold: float = 0.001
    max_features_per_octave: int = 512
    # stability limit of one explicit 2-D diffusion step; the FED
    # schedule (below) takes varying super-stable steps whose CYCLE is
    # stable, exactly the vendored lib's scheme
    fed_tau_max: float = 0.25


def _fed_tau_schedule(T: float, tau_max: float = 0.25):
    """Fast Explicit Diffusion step sizes for one cycle covering
    diffusion time T (Grewenig/Weickert FED, as used by the reference's
    vendored AKAZE: fed.cpp fed_tau_by_cycle_time). A cycle of n steps
    tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n + 2))) is stable as a
    whole even though individual steps exceed tau_max; n is chosen so
    the cycle time n(n+1)/3 * tau_max covers T, then the taus are
    scaled to sum exactly to T. Returns a host numpy array."""
    n = max(1, int(math.ceil(
        math.sqrt(3.0 * T / tau_max + 0.25) - 0.5 - 1e-8)))
    c = 1.0 / (4.0 * n + 2.0)
    taus = np.asarray([
        tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) * c) ** 2)
        for j in range(n)])
    return taus * (T / taus.sum())


def _gradients_scharr(img):
    """Scharr 3x3 derivatives (AKAZE uses Scharr for robustness) of
    img (..., H, W): one cross-correlation with both kernels on the
    edge-padded image."""
    kx = torch.tensor([[-3.0, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                      dtype=img.dtype, device=img.device) / 32.0
    w = torch.stack([kx, kx.T])[:, None]              # (2, 1, 3, 3)
    H, W = img.shape[-2:]
    x = F.pad(img.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="replicate")
    g = F.conv2d(x, w)                                # (B, 2, H, W)
    return (g[:, 0].reshape(img.shape), g[:, 1].reshape(img.shape))


def _diffuse_level(L, k_contrast, taus):
    """Explicit Perona-Malik G2 diffusion, one FED cycle:
    L += tau_i * div(g grad L) with the super-stable step schedule from
    _fed_tau_schedule (taus: (n,) tensor in L's dtype)."""
    for i in range(taus.shape[0]):
        lx, ly = _gradients_scharr(L)
        g = 1.0 / (1.0 + (lx * lx + ly * ly) / (k_contrast ** 2))
        # divergence of g * grad via central differences
        gx = g * lx
        gy = g * ly
        div = (0.5 * (torch.roll(gx, -1, -1) - torch.roll(gx, 1, -1)) +
               0.5 * (torch.roll(gy, -1, -2) - torch.roll(gy, 1, -2)))
        L = L + taus[i] * div
    return L


def _hessian_response(L, sigma):
    """Scale-normalized det(Hessian)."""
    lx, ly = _gradients_scharr(L)
    lxx, lxy = _gradients_scharr(lx)
    _, lyy = _gradients_scharr(ly)
    return (sigma ** 2) * (lxx * lyy - lxy * lxy)


_MS_CELLS = 4
_MS_SAMP = 20  # sample grid per side for the descriptor window


def _msurf_descriptors(L, sl, yk, xk, sigma_rel, theta):
    """M-SURF 64-d descriptor per keypoint.

    L: (S, H, W) evolution levels; sl (K,) integer levels, yk/xk/
    sigma_rel/theta (K,) in L's dtype. Gradient samples on a rotated
    _MS_SAMP x _MS_SAMP grid spanning 20*sigma, 4x4 overlapping cells of
    (sum dx, sum dy, sum |dx|, sum |dy|).
    """
    K = sl.shape[0]
    H, W = L.shape[1], L.shape[2]
    dt, dev = L.dtype, L.device
    gx = 0.5 * (torch.roll(L, -1, 2) - torch.roll(L, 1, 2))
    gy = 0.5 * (torch.roll(L, -1, 1) - torch.roll(L, 1, 1))

    g = (torch.arange(_MS_SAMP, dtype=dt, device=dev) + 0.5) / _MS_SAMP - 0.5
    gy_, gx_ = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx_.reshape(-1), gy_.reshape(-1)], -1)  # (P, 2)

    win = 20.0 * sigma_rel
    ct, st = torch.cos(theta), torch.sin(theta)
    ox = (grid[None, :, 0] * ct[:, None] -
          grid[None, :, 1] * st[:, None]) * win[:, None]
    oy = (grid[None, :, 0] * st[:, None] +
          grid[None, :, 1] * ct[:, None]) * win[:, None]
    sx = (xk[:, None] + ox).clamp(0, W - 2)
    sy = (yk[:, None] + oy).clamp(0, H - 2)
    x0 = sx.to(torch.int64)
    y0 = sy.to(torch.int64)
    fx = sx - x0
    fy = sy - y0
    base = (sl[:, None] * H + y0) * W + x0            # (K, P)

    def bil(vol):
        v = vol.reshape(-1)
        return (v[base] * (1 - fy) * (1 - fx) + v[base + 1] * (1 - fy) * fx +
                v[base + W] * fy * (1 - fx) + v[base + W + 1] * fy * fx)

    dx = bil(gx)
    dy = bil(gy)
    # rotate gradients into the keypoint frame
    rdx = dx * ct[:, None] + dy * st[:, None]
    rdy = -dx * st[:, None] + dy * ct[:, None]
    wgt = torch.exp(-(grid[None, :, 0] ** 2 + grid[None, :, 1] ** 2) /
                    (2 * 0.33 ** 2))
    rdx = rdx * wgt
    rdy = rdy * wgt

    # overlapping 4x4 cells: cell centers at (-0.375..0.375), triangular
    # spatial weights with half-width 0.25 (overlap)
    centers = (torch.arange(_MS_CELLS, dtype=dt, device=dev) + 0.5) \
        / _MS_CELLS - 0.5
    wu = torch.clamp_min(1.0 - (grid[:, 0][:, None] -
                                centers[None, :]).abs() / 0.25, 0.0)  # (P, 4)
    wv = torch.clamp_min(1.0 - (grid[:, 1][:, None] -
                                centers[None, :]).abs() / 0.25, 0.0)

    feats = torch.stack([rdx, rdy, rdx.abs(), rdy.abs()], -1)  # (K, P, 4)
    t1 = torch.einsum("kpc,pj->kjpc", feats, wv)
    cells = torch.einsum("kjpc,pi->kijc", t1, wu)    # (K, 4, 4, 4)
    desc = cells.reshape(K, _MS_CELLS * _MS_CELLS * 4)
    return desc / torch.clamp_min(
        torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-12)


def _top_k_stable(score, K):
    """The K largest entries of a 1-d score and their indices, equal
    scores in ascending index (jax.lax.top_k's order)."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:K], idx[:K]


def _extract_impl(image, opts: AkazeOptions, octave_shapes):
    """image (H, W) -> (kps (n·K, 4) float32, desc (n·K, 64), valid
    (n·K,)) over the n octaves."""
    S = opts.sublevels
    dt, dev = image.dtype, image.device
    base = _blur(image, 1.0)

    # contrast factor: the 70th percentile of |grad| on the base
    # (torch.quantile takes at most 2^24 elements: a 4096 x 4096 base;
    # the builder caps images at 3,200 px, 7.68M pixels at 4:3)
    lx, ly = _gradients_scharr(base)
    mag = torch.sqrt(lx * lx + ly * ly)
    k_contrast = torch.clamp_min(torch.quantile(mag.reshape(-1), 0.7), 1e-4)
    del lx, ly, mag

    outputs = []
    for o, (Ho, Wo) in enumerate(octave_shapes):
        levels = [base]
        for s in range(S):
            sigma = 1.6 * (2.0 ** (s / S))
            t_prev = 0.5 * (1.6 * 2.0 ** ((s - 1) / S)) ** 2 if s else 0.5
            t_cur = 0.5 * sigma ** 2
            taus = torch.as_tensor(_fed_tau_schedule(
                max(t_cur - t_prev, 1e-6), opts.fed_tau_max),
                dtype=dt, device=dev)
            levels.append(_diffuse_level(levels[-1], k_contrast, taus))
        L = torch.stack(levels[1:])                   # (S, Ho, Wo)
        resp = torch.stack([_hessian_response(L[s], 1.6 * 2.0 ** (s / S))
                            for s in range(S)])

        mx = F.max_pool3d(resp[None, None], 3, 1, 1)[0, 0]
        is_ext = (resp >= mx) & (resp > opts.detector_threshold)
        yy = torch.arange(Ho, device=dev)[None, :, None]
        xx = torch.arange(Wo, device=dev)[None, None, :]
        b = 10
        is_ext = is_ext & (yy >= b) & (yy < Ho - b) & (xx >= b) & \
            (xx < Wo - b)

        score = torch.where(is_ext, resp, 0.0).reshape(-1)
        top_score, flat = _top_k_stable(score, opts.max_features_per_octave)
        valid = top_score > 0
        slv = flat // (Ho * Wo)
        rem = flat % (Ho * Wo)
        iy = rem // Wo
        ix = rem % Wo

        dxl = 0.5 * (torch.roll(L, -1, 2) - torch.roll(L, 1, 2))
        dyl = 0.5 * (torch.roll(L, -1, 1) - torch.roll(L, 1, 1))
        mag_l = torch.sqrt(dxl ** 2 + dyl ** 2)
        ang_l = torch.atan2(dyl, dxl)
        del dxl, dyl
        sigma_rel = 1.6 * (2.0 ** (slv.to(dt) / S))
        theta = _keypoint_orientation_maps(mag_l, ang_l, slv, iy, ix,
                                           sigma_rel)
        del mag_l, ang_l
        desc = _msurf_descriptors(L, slv, iy.to(dt), ix.to(dt), sigma_rel,
                                  theta)
        scale_mult = 2.0 ** o
        kps = torch.stack([ix * scale_mult, iy * scale_mult,
                           sigma_rel * scale_mult, theta], -1)
        outputs.append((kps.to(torch.float32), desc, valid))
        base = levels[-1][::2, ::2]
        del L, resp, levels

    kps = torch.cat([x[0] for x in outputs])
    desc = torch.cat([x[1] for x in outputs])
    valid = torch.cat([x[2] for x in outputs])
    return kps, desc, valid


def _pad_and_shapes(img: np.ndarray, opts: AkazeOptions):
    """Host side: pad (H, W) with its edge to a multiple of 2^n for the
    n octaves of at least 40 px; returns (padded image, octave shapes)."""
    H, W = img.shape
    n_oct = opts.num_octaves
    shapes = []
    h, w = H, W
    for o in range(n_oct):
        if h < 40 or w < 40:
            break
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    H_pad = ((H - 1) // (1 << len(shapes)) + 1) * (1 << len(shapes))
    W_pad = ((W - 1) // (1 << len(shapes)) + 1) * (1 << len(shapes))
    img = np.pad(img, ((0, H_pad - H), (0, W_pad - W)), mode="edge")
    shapes = []
    h, w = H_pad, W_pad
    for o in range(n_oct):
        if h < 40 or w < 40:
            break
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return img, tuple(shapes)


def extract_akaze(image: np.ndarray, opts: AkazeOptions = AkazeOptions(),
                  device="cuda", dtype=torch.float32):
    """Extract AKAZE features from a grayscale image (H, W) in [0, 1] on
    `device` (the card by default; it raises without one), computing in
    `dtype` (float32, as the JAX module on a TPU; float64 to compare with
    JAX under x64). Returns numpy (keypoints (K, 4) [x, y, sigma, theta]
    float32, descriptors (K, 64), valid (K,) bool) with K = octaves *
    max_features_per_octave (fixed shape; filter by `valid`)."""
    device = resolve_device(device)
    img = np.asarray(image, np.float32)
    H, W = img.shape
    img, shapes = _pad_and_shapes(img, opts)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device=device,
                                                       dtype=dtype)
    with torch.no_grad(), full_f32():
        kps, desc, valid = _extract_impl(x, opts, shapes)
    kps, desc, valid = kps.cpu().numpy(), desc.cpu().numpy(), \
        valid.cpu().numpy()
    in_img = (kps[:, 0] < W) & (kps[:, 1] < H)
    return kps, desc, valid & in_img
