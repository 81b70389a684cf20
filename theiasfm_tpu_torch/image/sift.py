"""SIFT feature detection and description in PyTorch (port of
theiasfm_tpu/image/sift.py).

The same fixed-shape formulation of Lowe's algorithm as the JAX module:

  * a Gaussian scale space per octave by separable convolutions,
  * DoG extrema as dense stencil ops (3x3x3 max/min pooling), one
    quadratic subpixel step and edge rejection at every voxel,
  * a static keypoint budget per octave chosen with topk (invalid slots
    masked),
  * orientation histogram and the 4x4x8 descriptor from one fixed-size
    gradient patch per keypoint, binned with one-hot contractions.

It has no kernel of its own: every step is plain PyTorch. Every internal
function takes any number of leading batch dimensions (the JAX module
vmaps over images; here the batch is written out), and level, row and
column are always the last three dimensions.

Precision: on the card cuDNN would run the float32 blur convolutions in
TF32, which keeps about three digits and flips extrema and thresholds.
The entry points run under `utils.device.full_f32`, which turns TF32 off
for convolutions and matrix products alike while they run, so the blur
is `F.conv2d` in full float32.

Each octave's stages run under profiler ranges ("sift.pyramid",
"sift.detect", "sift.patches", "sift.orientation", "sift.descriptors")
that chip_smoke.py reads for its time breakdown.

Keypoints: (x, y, scale_sigma, orientation) in input-image pixels.
Descriptors: 128-d L2-normalized, clipped at 0.2, renormalized (Lowe).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..utils.device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class SiftOptions:
    """Density knobs mirror ref SiftParameters (sift_parameters.h)."""
    num_octaves: int = 4
    levels_per_octave: int = 3
    sigma0: float = 1.6
    peak_threshold: float = 1.7 / 255.0   # vlfeat-style on DoG values
    edge_threshold: float = 10.0
    max_features_per_octave: int = 1024
    upsample: bool = False  # first_octave = -1 equivalent
    # ref SiftParameters descriptor knobs (sift_parameters.h:68-72).
    # The reference DEFAULTS to root_sift=True, upright_sift=True; our
    # defaults preserve classic (oriented, L2) SIFT — flip both for
    # reference-default behavior.
    root_sift: bool = False   # desc <- sqrt(desc / ||desc||_1)
    upright: bool = False     # skip orientation assignment (theta=0)


def _gauss_kernel(sigma: float, dtype=torch.float32, device=None):
    radius = max(int(np.ceil(3.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return torch.tensor(k, dtype=dtype, device=device)


def _blur(img, sigma: float):
    """Separable Gaussian blur with reflect padding. img (..., H, W)."""
    k = _gauss_kernel(sigma, img.dtype, img.device)
    r = (k.shape[0] - 1) // 2
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))
    return x.reshape(img.shape)


def _downsample2(img):
    return img[..., ::2, ::2]


def _min_max_pool3(x):
    """(..., S, H, W) -> 3x3x3 neighborhood max and min (same shape);
    neighbours outside the volume are ignored (max_pool3d pads with
    -inf, the min is the max of -x)."""
    v = x.reshape(-1, 1, *x.shape[-3:])
    mx = F.max_pool3d(v, 3, 1, 1).reshape(x.shape)
    mn = -F.max_pool3d(-v, 3, 1, 1).reshape(x.shape)
    return mx, mn


def _octave_keypoints(gauss, opts: SiftOptions):
    """Detect keypoints in one octave.

    gauss: (..., S+3, H, W) Gaussian levels. Returns (score, y, x, s
    (float refined), sl, iy, ix, valid), each (..., K) with K =
    max_features_per_octave.
    """
    S = opts.levels_per_octave
    dog = gauss[..., 1:, :, :] - gauss[..., :-1, :, :]   # (..., S+2, H, W)
    L, H, W = dog.shape[-3:]
    lead = dog.shape[:-3]

    mx, mn = _min_max_pool3(dog)
    is_ext = ((dog >= mx) | (dog <= mn)) & \
        (dog.abs() > 0.8 * opts.peak_threshold)

    # derivatives (central differences over the full volume; roll wraps
    # around as jnp.roll does, and the border mask below drops the
    # wrapped voxels)
    S_, Y_, X_ = -3, -2, -1
    ds = 0.5 * (torch.roll(dog, -1, S_) - torch.roll(dog, 1, S_))
    dy = 0.5 * (torch.roll(dog, -1, Y_) - torch.roll(dog, 1, Y_))
    dx = 0.5 * (torch.roll(dog, -1, X_) - torch.roll(dog, 1, X_))
    dss = torch.roll(dog, -1, S_) + torch.roll(dog, 1, S_) - 2 * dog
    dyy = torch.roll(dog, -1, Y_) + torch.roll(dog, 1, Y_) - 2 * dog
    dxx = torch.roll(dog, -1, X_) + torch.roll(dog, 1, X_) - 2 * dog
    dxy = 0.25 * (torch.roll(torch.roll(dog, -1, Y_), -1, X_) -
                  torch.roll(torch.roll(dog, -1, Y_), 1, X_) -
                  torch.roll(torch.roll(dog, 1, Y_), -1, X_) +
                  torch.roll(torch.roll(dog, 1, Y_), 1, X_))
    dxs = 0.25 * (torch.roll(torch.roll(dog, -1, S_), -1, X_) -
                  torch.roll(torch.roll(dog, -1, S_), 1, X_) -
                  torch.roll(torch.roll(dog, 1, S_), -1, X_) +
                  torch.roll(torch.roll(dog, 1, S_), 1, X_))
    dys = 0.25 * (torch.roll(torch.roll(dog, -1, S_), -1, Y_) -
                  torch.roll(torch.roll(dog, -1, S_), 1, Y_) -
                  torch.roll(torch.roll(dog, 1, S_), -1, Y_) +
                  torch.roll(torch.roll(dog, 1, S_), 1, Y_))

    # solve the symmetric 3x3 system Hess @ off = -grad at every voxel
    # in closed adjugate form on per-component arrays
    a, b_, c = dxx + 1e-8, dxy, dxs
    e, f, i_ = dyy + 1e-8, dys, dss + 1e-8
    A11 = e * i_ - f * f
    A12 = c * f - b_ * i_
    A13 = b_ * f - c * e
    A22 = a * i_ - c * c
    A23 = b_ * c - a * f
    A33 = a * e - b_ * b_
    det = a * A11 + b_ * A12 + c * A13
    det = torch.where(det.abs() < 1e-12,
                      torch.where(det < 0, -1e-12, 1e-12).to(det.dtype), det)
    off_x = -(A11 * dx + A12 * dy + A13 * ds) / det
    off_y = -(A12 * dx + A22 * dy + A23 * ds) / det
    off_s = -(A13 * dx + A23 * dy + A33 * ds) / det
    refined = dog + 0.5 * (dx * off_x + dy * off_y + ds * off_s)

    # edge rejection on the 2x2 spatial Hessian
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = opts.edge_threshold
    edge_ok = (det > 0) & (tr * tr / torch.where(det <= 0, 1.0, det) <
                           (r + 1) ** 2 / r)

    off_max = torch.maximum(torch.maximum(off_x.abs(), off_y.abs()),
                            off_s.abs())
    good = (is_ext & edge_ok &
            (refined.abs() > opts.peak_threshold) &
            (off_max < 1.5))
    # only levels 1..S are valid extrema layers; exclude borders
    dev = dog.device
    lvl = torch.arange(L, device=dev)[:, None, None]
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    b = 5
    good = good & (lvl >= 1) & (lvl <= S) & \
        (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)

    score = torch.where(good, refined.abs(), 0.0).reshape(*lead, -1)
    K = opts.max_features_per_octave
    top_score, flat_idx = torch.topk(score, K, dim=-1)
    valid = top_score > 0
    sl = flat_idx // (H * W)
    rem = flat_idx % (H * W)
    iy = rem // W
    ix = rem % W

    def at(t):
        return t.reshape(*lead, -1).gather(-1, flat_idx)

    x_ref = ix + at(off_x)
    y_ref = iy + at(off_y)
    s_ref = sl + at(off_s)
    return top_score, y_ref, x_ref, s_ref, sl, iy, ix, valid


def _grad_xy(img):
    gy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    gx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    return gx, gy


_ORI_BINS = 36
_WIN = 16  # orientation sampling window (fixed)
# Per-keypoint gradient-patch side. Orientation and descriptor both read
# only this patch, taken per keypoint from edge-padded gradient maps.
# 88 covers the worst-case rotated descriptor window: sigma_rel <=
# 1.6 * 2^(4.5/3) = 4.53, win = 3*sigma*NBP = 54.3, half-diagonal 38.4,
# + subpixel offset 1.5 + bilinear support -> radius 41.
_PATCH = 88
_PR = _PATCH // 2


def _extract_patches(gx_pad, gy_pad, sl, iy, ix):
    """(..., K, PATCH, PATCH) gradient patches, centered so the
    keypoint's integer pixel sits at (PR, PR). gx_pad/gy_pad (..., L,
    Hp, Wp) are the per-octave gradient pyramids edge-padded by PR on
    both spatial axes; sl/iy/ix (..., K). One gather per map. The start
    indices are clamped to the array as jax.lax.dynamic_slice clamps
    them (with the PR padding the clamp never binds)."""
    L, Hp, Wp = gx_pad.shape[-3:]
    lead = sl.shape[:-1]
    K = sl.shape[-1]
    s = sl.clamp(0, L - 1)
    y = iy.clamp(0, Hp - _PATCH)
    x = ix.clamp(0, Wp - _PATCH)
    ar = torch.arange(_PATCH, device=gx_pad.device)
    offs = (ar[:, None] * Wp + ar[None, :]).reshape(-1)   # (PATCH²,)
    start = (s * Hp + y) * Wp + x                          # (..., K)
    lin = (start[..., None] + offs).reshape(*lead, -1)     # (..., K·PATCH²)

    def take(m):
        return m.reshape(*lead, -1).gather(-1, lin).reshape(
            *lead, K, _PATCH, _PATCH)
    return take(gx_pad), take(gy_pad)


def _one_hot(idx, n, dtype):
    return (idx[..., None] ==
            torch.arange(n, device=idx.device)).to(dtype)


def _hist_orientation(w, a):
    """36-bin weighted orientation histogram (one-hot contraction, no
    scatter) -> smoothed peak with parabolic refinement. w, a (..., P)."""
    bin_f = torch.remainder(a / (2 * math.pi) * _ORI_BINS, _ORI_BINS)
    b0 = torch.remainder(torch.floor(bin_f).long(), _ORI_BINS)
    frac = bin_f - torch.floor(bin_f)
    oh = (_one_hot(b0, _ORI_BINS, w.dtype) * (w * (1 - frac))[..., None] +
          _one_hot((b0 + 1) % _ORI_BINS, _ORI_BINS, w.dtype) *
          (w * frac)[..., None])
    hist = oh.sum(-2)                                # (..., 36)
    for _ in range(3):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = hist.argmax(-1, keepdim=True)

    def at(i):
        return hist.gather(-1, i)[..., 0]
    hp = at(peak)
    hl = at((peak - 1) % _ORI_BINS)
    hr = at((peak + 1) % _ORI_BINS)
    denom = hl - 2 * hp + hr
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    return (peak[..., 0] + delta + 0.5) * (2 * math.pi / _ORI_BINS)


def _keypoint_orientation_maps(mag_pyr, ang_pyr, sl, iy, ix, sigma_rel):
    """Dominant orientation from full magnitude/angle maps by per-sample
    gathers, for callers that already hold polar gradient maps (AKAZE;
    SIFT itself takes the patch route of _keypoint_orientation).
    mag_pyr/ang_pyr (L, H, W); sl/iy/ix (K,) integer; sigma_rel (K,).
    The (2r+1)^2 window is clipped to the map at its border."""
    r = _WIN // 2
    L, H, W = mag_pyr.shape
    d = torch.arange(-r, r + 1, device=mag_pyr.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dy, dx = dy.reshape(-1), dx.reshape(-1)                 # (P,)
    ys = (iy[:, None] + dy).clamp(0, H - 1)
    xs = (ix[:, None] + dx).clamp(0, W - 1)
    flat = (sl[:, None] * H + ys) * W + xs                  # (K, P)
    m = mag_pyr.reshape(-1)[flat]
    a = ang_pyr.reshape(-1)[flat]
    d2 = (dy * dy + dx * dx).to(m.dtype)
    w_sigma = 1.5 * sigma_rel
    w = torch.exp(-d2 / (2.0 * w_sigma[:, None] ** 2)) * m
    return _hist_orientation(w, a)


def _keypoint_orientation(pgx, pgy, sigma_rel):
    """Dominant gradient orientation per keypoint from its patch.

    pgx/pgy: (..., K, PATCH, PATCH); sigma_rel (..., K) in octave
    pixels. The 17x17 window is a static patch slice.
    """
    r = _WIN // 2
    win = slice(_PR - r, _PR + r + 1)
    wx = pgx[..., win, win]
    wy = pgy[..., win, win]
    m = torch.sqrt(wx * wx + wy * wy + 1e-20).flatten(-2)   # (..., K, P)
    a = torch.atan2(wy, wx).flatten(-2)
    d = torch.arange(-r, r + 1, device=pgx.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    d2 = (dy * dy + dx * dx).reshape(-1).to(m.dtype)
    w_sigma = 1.5 * sigma_rel
    w = torch.exp(-d2 / (2.0 * w_sigma[..., None] ** 2)) * m
    return _hist_orientation(w, a)  # [0, 2pi)


_NBP = 4   # descriptor spatial bins
_NBO = 8   # orientation bins
_DSAMP = 16  # sample grid per side


def _descriptors(pgx, pgy, dyk, dxk, sigma_rel, theta):
    """4x4x8 SIFT descriptor per keypoint via bilinear sampling of its
    gradient patch on a rotated grid, as two small weight-matrix
    contractions per gradient map (no gathers). dyk/dxk are the
    subpixel offsets of the refined keypoint from the patch center.
    pgx/pgy (..., K, PATCH, PATCH); the rest (..., K)."""
    dev, dt = pgx.device, pgx.dtype
    # sample grid in descriptor frame: NBP bins, 3*sigma spacing per bin
    g = (torch.arange(_DSAMP, dtype=dt, device=dev) + 0.5) / _DSAMP - 0.5
    gy_, gx_ = torch.meshgrid(g, g, indexing="ij")
    gx_, gy_ = gx_.reshape(-1), gy_.reshape(-1)      # (P,)

    win = 3.0 * sigma_rel * _NBP                     # full window width
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    # rotated offsets in octave pixels
    ox = (gx_ * ct - gy_ * st) * win[..., None]
    oy = (gx_ * st + gy_ * ct) * win[..., None]
    # positions in PATCH coordinates (keypoint integer pixel at PR)
    sx = torch.clamp(dxk[..., None] + ox + _PR, 0.0, _PATCH - 1.001)
    sy = torch.clamp(dyk[..., None] + oy + _PR, 0.0, _PATCH - 1.001)

    # bilinear sampling as two weight contractions: w[k, p, t] has the
    # two-tap tent profile max(0, 1 - |s - t|) along each patch axis
    taps = torch.arange(_PATCH, dtype=dt, device=dev)
    wyt = torch.clamp_min(1.0 - (sy[..., None] - taps).abs(), 0.0)
    wxt = torch.clamp_min(1.0 - (sx[..., None] - taps).abs(), 0.0)
    gxs = (torch.einsum("...yx,...py->...px", pgx, wyt) * wxt).sum(-1)
    gys = (torch.einsum("...yx,...py->...px", pgy, wyt) * wxt).sum(-1)
    del wyt, wxt
    m = torch.sqrt(gxs * gxs + gys * gys + 1e-20)
    a = torch.atan2(gys, gxs)
    a_rel = torch.remainder(a - theta[..., None], 2 * math.pi)

    # Gaussian weight over the window
    r2 = gx_ ** 2 + gy_ ** 2
    wgt = torch.exp(-r2 / (2 * 0.25))  # sigma = 0.5 window halves
    contrib = m * wgt                                # (..., K, P)

    # trilinear binning into (NBP, NBP, NBO)
    u = (gx_ + 0.5) * _NBP - 0.5                     # (P,)
    v = (gy_ + 0.5) * _NBP - 0.5
    ob = a_rel / (2 * math.pi) * _NBO                # (..., K, P)

    centers = torch.arange(_NBP, dtype=dt, device=dev)
    wu = torch.clamp_min(1.0 - (u[:, None] - centers).abs(), 0.0)  # (P, NBP)
    wv = torch.clamp_min(1.0 - (v[:, None] - centers).abs(), 0.0)
    o0 = torch.remainder(torch.floor(ob).long(), _NBO)
    of = ob - torch.floor(ob)
    wo = (_one_hot(o0, _NBO, dt) * (1 - of)[..., None] +
          _one_hot((o0 + 1) % _NBO, _NBO, dt) * of[..., None])

    # desc[k, j, i, o] = sum_p contrib[k,p] wu[p,i] wv[p,j] wo[k,p,o]
    # — bin order (y, x, orientation), vlfeat's memory layout
    cw = contrib[..., None] * wo                     # (..., K, P, NBO)
    t1 = torch.einsum("...po,pj->...jpo", cw, wv)    # (..., K, NBP, P, NBO)
    desc = torch.einsum("...jpo,pi->...jio", t1, wu)
    desc = desc.flatten(-3)                          # (..., K, 128)

    # Lowe normalization: L2 -> clip 0.2 -> L2
    desc = desc / torch.clamp_min(
        torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-12)
    desc = torch.clamp_max(desc, 0.2)
    desc = desc / torch.clamp_min(
        torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-12)
    return desc


def _extract_impl(image, opts: SiftOptions, octave_shapes):
    """image (..., H, W) -> (kps (..., n·K, 4), desc (..., n·K, 128),
    valid (..., n·K), score (..., n·K)) over the n octaves."""
    S = opts.levels_per_octave
    k = 2.0 ** (1.0 / S)
    # assume input pre-blurred at 0.5; bring to sigma0
    sig_init = float(np.sqrt(max(opts.sigma0 ** 2 - 0.5 ** 2, 0.01)))
    base = _blur(image, sig_init)

    all_out = []
    for o, _ in enumerate(octave_shapes):
        with record_function("sift.pyramid"):
            gauss = [base]
            sig_prev = opts.sigma0
            for s in range(1, S + 3):
                sig_total = opts.sigma0 * (k ** s)
                sig_delta = float(np.sqrt(max(sig_total ** 2 -
                                              sig_prev ** 2, 1e-4)))
                gauss.append(_blur(gauss[-1], sig_delta))
                sig_prev = sig_total
            G = torch.stack(gauss, dim=-3)            # (..., S+3, Ho, Wo)
            del gauss

        with record_function("sift.detect"):
            score, y_ref, x_ref, s_ref, sl, iy, ix, valid = \
                _octave_keypoints(G, opts)
        with record_function("sift.patches"):
            gx, gy = _grad_xy(G)
            pad = (_PR, _PR, _PR, _PR)
            gx = F.pad(gx, pad, mode="replicate")
            gy = F.pad(gy, pad, mode="replicate")
            # one contiguous patch per keypoint; start (iy, ix) in the
            # padded maps puts the keypoint's pixel at (PR, PR)
            pgx, pgy = _extract_patches(gx, gy, sl, iy, ix)
            del gx, gy
        sigma_rel = opts.sigma0 * (k ** s_ref)        # octave pixels
        with record_function("sift.orientation"):
            if opts.upright:
                # ref upright_sift: one canonical-orientation descriptor
                theta = torch.zeros_like(sigma_rel)
            else:
                theta = _keypoint_orientation(pgx, pgy, sigma_rel)
        with record_function("sift.descriptors"):
            desc = _descriptors(pgx, pgy, y_ref - iy, x_ref - ix,
                                sigma_rel, theta)
        del pgx, pgy
        if opts.root_sift:
            # RootSIFT (Arandjelovic-Zisserman): L1-normalize + sqrt,
            # so L2 distance on the result = Hellinger distance
            desc = torch.sqrt(desc / torch.clamp_min(
                desc.sum(-1, keepdim=True), 1e-12))
        scale_mult = 2.0 ** o * (0.5 if opts.upsample else 1.0)
        kps = torch.stack([
            x_ref * scale_mult, y_ref * scale_mult,
            sigma_rel * scale_mult, theta], -1)       # (..., K, 4)
        all_out.append((kps, desc, valid, score))
        base = _downsample2(G[..., S, :, :])          # next octave seed

    kps = torch.cat([o[0] for o in all_out], -2)
    desc = torch.cat([o[1] for o in all_out], -2)
    valid = torch.cat([o[2] for o in all_out], -1)
    score = torch.cat([o[3] for o in all_out], -1)
    return kps, desc, valid, score


def _pad_and_shapes(img: np.ndarray, opts: SiftOptions):
    """Host-side: pad (H, W) so every octave halves exactly; returns
    (padded image, octave shapes tuple)."""
    H, W = img.shape
    shapes = []
    h, w = H, W
    for _ in range(opts.num_octaves):
        if h < 16 or w < 16:
            break
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    H_pad = ((H - 1) // (1 << len(shapes)) + 1) * (1 << len(shapes))
    W_pad = ((W - 1) // (1 << len(shapes)) + 1) * (1 << len(shapes))
    img = np.pad(img, ((0, H_pad - H), (0, W_pad - W)), mode="edge")
    shapes = []
    h, w = H_pad, W_pad
    for _ in range(opts.num_octaves):
        if h < 16 or w < 16:
            break
        shapes.append((h, w))
        h, w = h // 2, w // 2
    return img, tuple(shapes)


def _run(padded: np.ndarray, opts: SiftOptions, shapes, device):
    """Extraction of a (B, H, W) stack on `device`, as numpy arrays."""
    x = torch.from_numpy(np.ascontiguousarray(padded)).to(device)
    with torch.no_grad(), full_f32():
        kps, desc, valid, _ = _extract_impl(x, opts, shapes)
    return kps.cpu().numpy(), desc.cpu().numpy(), valid.cpu().numpy()


def extract_sift_batch(images, opts: SiftOptions = SiftOptions(),
                       device="cuda"):
    """Batched SIFT over same-shape grayscale images ((B, H, W) stack
    or list of equal-shape arrays) on `device` (the card by default; it
    raises without one). Returns per-image (keypoints, descriptors,
    valid) numpy arrays like extract_sift."""
    device = resolve_device(device)
    imgs = [np.asarray(im, np.float32) for im in images]
    H, W = imgs[0].shape
    if not all(im.shape == (H, W) for im in imgs):
        raise ValueError("extract_sift_batch needs same-shape images")
    if opts.upsample:
        imgs = [np.kron(im, np.ones((2, 2), np.float32))
                for im in imgs]
    padded, shapes = zip(*[_pad_and_shapes(im, opts) for im in imgs])
    kps, desc, valid = _run(np.stack(padded), opts, shapes[0], device)
    # keypoint coords are in ORIGINAL image scale (scale_mult undoes
    # the upsample), so gate against the pre-upsample dims
    in_img = (kps[..., 0] < W) & (kps[..., 1] < H)
    valid = valid & in_img
    return [(kps[b], desc[b], valid[b]) for b in range(len(imgs))]


def extract_sift(image: np.ndarray, opts: SiftOptions = SiftOptions(),
                 device="cuda"):
    """Extract SIFT features from a grayscale image (H, W) in [0, 1] on
    `device` (the card by default; it raises without one).

    Returns (keypoints (K, 4) [x, y, sigma, theta], descriptors
    (K, 128), valid (K,) bool) numpy arrays with K = num_octaves *
    max_features_per_octave (fixed shape; filter by `valid`).
    """
    device = resolve_device(device)
    img = np.asarray(image, np.float32)
    if opts.upsample:
        img = np.kron(img, np.ones((2, 2), np.float32))
    H, W = img.shape
    img, shapes = _pad_and_shapes(img, opts)
    kps, desc, valid = _run(img[None], opts, shapes, device)
    kps, desc, valid = kps[0], desc[0], valid[0]
    # drop keypoints that fell into the padded margin
    in_img = (kps[:, 0] < W) & (kps[:, 1] < H)
    valid = valid & in_img
    return kps, desc, valid
