"""Fused observation sweeps of the bundle adjuster: the counterpart of
theiasfm_tpu/sfm/ba/pallas_matvec.py. The Schur-complement matvec of the
CG loop (pass1, pass2) and the normal-equation blocks of make_blocks
(blocks, below).

One matrix-free product S·v is two sweeps over the observations with a
small torch step between them (bundle_adjustment.solve_normal_eqs):

    u, wp  = pass1(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts)
    zp     = Hpp^-1 wp                           (torch glue)
    yc, yg = pass2(jc, ji, jp, obs_cam, obs_pt, u, zp, n_cams, cam_index)

cam_index = camera_index(obs_cam, n_cams) is pass 2's camera index (the
observations in camera order, each camera's segment and, on CUDA, stage
A's (M, 6) workspace), built once per solve; pass 2 on CUDA requires it.

The jacobians come as any strided (F, M) view: a (12, M) tensor (the
transposed layout, `pallas_transposed=True`) or the `.T` of an (M, 12)
tensor (the row layout); f32 or bf16 (the matvec type), all three the
same type. u is (2, M) f32, wp (Np, 3), yc (Nc, 6), yg (2P, 2) f32.

Each wrapper dispatches on the device of its tensors: on the CPU it
runs the plain PyTorch version beside it (the CPU tests use it); on a
CUDA tensor it launches the hand-written kernel of
csrc/schur_matvec.cu (csrc/ba_blocks.cu for blocks), or raises. There is
no fallback from one to the other. Each CUDA launch adds one to its count
in utils/dispatch.py ("schur_pass1", "schur_pass2", "ba_blocks").

The kernels use the global point ids directly: the TPU's tile plan
(tile_p0, local_pt, the point window) exists because VMEM could not
hold a whole point table, and a GPU block reads zp[obs_pt] from device
memory. MatvecPlan and PlanShapes are kept, computed exactly as in the
JAX package, because the problem preparation attaches the plan and
the solver decides kernel eligibility from it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...utils.dispatch import count_dispatch


def _round_up(x, m):
    return -(-x // m) * m


class MatvecPlan:
    """Host-side static per-problem data for the fused matvec (same
    fields and values as the JAX package's MatvecPlan)."""

    def __init__(self, obs_cam, obs_pt, n_cams, n_pts, block=512,
                 force_window=None):
        obs_cam = np.asarray(obs_cam)
        obs_pt = np.asarray(obs_pt)
        M = obs_cam.shape[0]
        if M % block:
            raise ValueError(f"M={M} is not a multiple of block={block}")
        if np.any(np.diff(obs_pt) < 0):
            raise ValueError("observations must be sorted by point")
        self.M, self.B = M, block
        self.G = M // block
        self.Nc = n_cams
        self.Np = n_pts
        # point window per tile: the largest point span of any tile,
        # with p0 8-aligned (+8 covers the alignment shift)
        p0 = (obs_pt[::block].astype(np.int32) // 8) * 8
        rel_raw = obs_pt.reshape(self.G, block) - p0[:, None]
        self.W = int(_round_up(int(rel_raw.max()) + 1, 8))
        if force_window is not None:
            if force_window < self.W:
                raise ValueError(f"force_window={force_window} < W={self.W}")
            self.W = int(force_window)
        self.Np_pad = _round_up(n_pts + self.W, 8)
        self.tile_p0 = np.minimum(p0, self.Np_pad - self.W)
        self.cam_chunk = (_round_up(n_cams, 8) if n_cams <= 1024
                          else 256)
        self.cam_pad = _round_up(n_cams, self.cam_chunk)
        rel = (obs_pt.reshape(self.G, block) - self.tile_p0[:, None])
        if not ((rel >= 0).all() and (rel < self.W).all()):
            raise ValueError("point window does not cover a tile")
        self.local_pt = rel.astype(np.int32)
        self.cam_tiles = obs_cam.reshape(self.G, block).astype(np.int32)


class PlanShapes:
    """Shape-only plan view (the plan's arrays live in BAProblem
    fields)."""

    def __init__(self, G, B, Nc, Np, W):
        self.G, self.B, self.W = G, B, W
        self.M = G * B
        self.Nc, self.Np = Nc, Np
        self.cam_chunk = (_round_up(Nc, 8) if Nc <= 1024
                          else 256)
        self.cam_pad = _round_up(Nc, self.cam_chunk)
        self.Np_pad = _round_up(Np + W, 8)


# ---------------------------------------------------------------------------
# plain PyTorch versions (same signatures and rounding points as the
# kernels; the CPU path and the reference the kernels are held against)

def round_mv(x, mv_dtype):
    """Round x to the matvec type and back to x's type (identity when
    they agree)."""
    return x if mv_dtype == x.dtype else x.to(mv_dtype).to(x.dtype)


def pass1_plain(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts):
    """u = Jc·vc[cam] + Ji·vg (2, M) f32; wp[pt] += Jpᵀ round(u)."""
    mv = jc.dtype
    M = jc.shape[1]
    P = ji.shape[0] // 2
    f32 = torch.float32
    vc_m = round_mv(vc[obs_cam], mv)                       # (M, 6)
    vg_m = round_mv(vg, mv)                                # (P,)
    jc3 = jc.to(f32).reshape(2, 6, M)
    ji3 = ji.to(f32).reshape(2, P, M)
    # contiguous like the kernel's u, so either feeds either pass 2
    u = (torch.einsum("kim,mi->km", jc3, vc_m) +
         torch.einsum("kpm,p->km", ji3, vg_m)).contiguous()
    um = round_mv(u, mv)
    t = torch.einsum("kcm,km->mc", jp.to(f32).reshape(2, 3, M), um)
    wp = torch.zeros((n_pts, 3), dtype=f32, device=jc.device)
    wp.index_add_(0, obs_pt, t)
    return u, wp


def pass2_plain(jc, ji, jp, obs_cam, obs_pt, u, zp, n_cams):
    """d = round(u − Jp·round(zp[pt])); yc[cam] += Jcᵀd (Nc, 6);
    yg = Ji dᵀ (2P, 2); all f32."""
    mv = jc.dtype
    M = jc.shape[1]
    f32 = torch.float32
    zm = round_mv(zp[obs_pt], mv)                          # (M, 3)
    u2 = torch.einsum("kcm,mc->km", jp.to(f32).reshape(2, 3, M), zm)
    dm = round_mv(u - u2, mv)                              # (2, M)
    ycb = torch.einsum("kim,km->mi", jc.to(f32).reshape(2, 6, M), dm)
    yc = torch.zeros((n_cams, 6), dtype=f32, device=jc.device)
    yc.index_add_(0, obs_cam, ycb)
    yg = ji.to(f32) @ dm.T
    return yc, yg


MAX_P = 10          # intrinsics groups the kernels take


@functools.cache
def _part_blocks(device_index):
    """Pass 2's stage-A grid cap on this device, read once per device: 16
    blocks of 256 threads per SM (on the H100 a few observations per
    thread at Notre-Dame; fewer, longer-lived blocks measured slower)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return 16 * sms


class CameraIndex(NamedTuple):
    """Pass 2's camera index, fixed by obs_cam (see camera_index)."""
    order: torch.Tensor             # (M,) int32
    start: torch.Tensor             # (n_cams + 1,) int32
    y_work: Optional[torch.Tensor]  # (M, 6) f32 on CUDA, else None
    g_work: Optional[torch.Tensor]  # (blocks, 4 MAX_P) f32 on CUDA


def camera_index(obs_cam, n_cams):
    """Pass 2's camera index: cam_order, the observations sorted by
    camera, stably, so each camera keeps point order; cam_start, where
    each camera's segment of cam_order starts (cam_start[-1] = M). On a
    CUDA device it also holds the kernel's workspaces: y_work, the (M, 6)
    rows that stage A writes and stage B reads, and g_work, stage A's
    group partials, one row per block of its grid (the device's cap).
    Every pass 2 given this index reuses them, so calls that share it run
    on one stream. On obs_cam's device."""
    dev = obs_cam.device
    order = torch.sort(obs_cam, stable=True).indices.to(torch.int32)
    counts = torch.bincount(obs_cam.long(), minlength=n_cams)
    start = torch.zeros(n_cams + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(counts, 0)
    if dev.type != "cuda":
        return CameraIndex(order, start, None, None)
    parts = _part_blocks(dev.index if dev.index is not None
                         else torch.cuda.current_device())
    f32 = torch.float32
    return CameraIndex(
        order, start,
        torch.empty((obs_cam.shape[0], 6), dtype=f32, device=dev),
        torch.empty((parts, 4 * MAX_P), dtype=f32, device=dev))


def camera_sums_plain(y, cam_index):
    """Plain version of pass 2's stage B: the (M, F) rows of y summed per
    camera over the segments of cam_index, (n_cams, F)."""
    lengths = (cam_index.start[1:] - cam_index.start[:-1]).long()
    return torch.segment_reduce(y[cam_index.order.long()], "sum",
                                lengths=lengths, unsafe=True)


# ---------------------------------------------------------------------------
# wrappers

MV_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_jacobians(jc, ji, jp):
    M = jc.shape[1]
    if jc.dim() != 2 or jc.shape[0] != 12:
        raise ValueError(f"jc must be (12, M), got {tuple(jc.shape)}")
    if ji.dim() != 2 or ji.shape[0] % 2 or ji.shape[1] != M:
        raise ValueError(f"ji must be (2P, {M}), got {tuple(ji.shape)}")
    if jp.shape != (6, M):
        raise ValueError(f"jp must be (6, {M}), got {tuple(jp.shape)}")
    if not (jc.dtype == ji.dtype == jp.dtype) or jc.dtype not in MV_DTYPES:
        raise TypeError("jacobians must share one type, float32 or "
                        f"bfloat16: {jc.dtype}, {ji.dtype}, {jp.dtype}")
    P = ji.shape[0] // 2
    if not 1 <= P <= MAX_P:
        raise ValueError(f"P={P} outside 1..{MAX_P}")
    return M, P


def _check_cuda(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"the BA kernels run on CUDA, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"tensor on {t.device}, expected {dev}")


def _check_vec(name, t, shape, dtype):
    if tuple(t.shape) != shape or t.dtype != dtype or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _strides(jc, ji, jp):
    return [s for t in (jc, ji, jp) for s in t.stride()]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def pass1(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts):
    """First sweep of S·v. Returns (u (2, M) f32, wp (n_pts, 3) f32)."""
    if jc.device.type == "cpu":
        return pass1_plain(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts)
    M, P = _check_jacobians(jc, ji, jp)
    _check_cuda(jc, ji, jp, obs_cam, obs_pt, vc, vg)
    Nc = vc.shape[0]
    _check_vec("obs_cam", obs_cam, (M,), torch.int32)
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    _check_vec("vc", vc, (Nc, 6), torch.float32)
    _check_vec("vg", vg, (P,), torch.float32)
    # the kernel writes u whole and adds into wp
    u = torch.empty((2, M), dtype=torch.float32, device=jc.device)
    wp = torch.zeros((n_pts, 3), dtype=torch.float32, device=jc.device)
    if M == 0:
        return u, wp
    from ... import _kernels
    name = f"schur_pass1_{_SUFFIX[jc.dtype]}"
    fn = getattr(_kernels.library(), name)
    err = fn(jc.data_ptr(), ji.data_ptr(), jp.data_ptr(),
             *_strides(jc, ji, jp), obs_cam.data_ptr(), obs_pt.data_ptr(),
             vc.data_ptr(), vg.data_ptr(), u.data_ptr(), wp.data_ptr(),
             M, P, torch.cuda.current_stream(jc.device).cuda_stream)
    _raise_on(err, name)
    count_dispatch("schur_pass1")
    return u, wp


def pass2(jc, ji, jp, obs_cam, obs_pt, u, zp, n_cams, cam_index=None):
    """Second sweep of S·v. Returns (yc (n_cams, 6) f32, yg (2P, 2)
    f32). cam_index: camera_index(obs_cam, n_cams), required on CUDA,
    where it replaces obs_cam (a solve builds it once); the CPU path
    ignores it."""
    if jc.device.type == "cpu":
        return pass2_plain(jc, ji, jp, obs_cam, obs_pt, u, zp, n_cams)
    M, P = _check_jacobians(jc, ji, jp)
    _check_cuda(jc, ji, jp, obs_pt, u, zp)
    if not isinstance(cam_index, CameraIndex) or cam_index.y_work is None:
        raise ValueError("pass2 on CUDA takes cam_index=camera_index("
                         "obs_cam, n_cams) on the card, built once per "
                         "solve")
    order, start, y_work, g_work = cam_index
    _check_cuda(jc, order, start, y_work, g_work)
    if order.shape != (M,) or start.shape != (n_cams + 1,):
        raise ValueError(f"cam_index is for {order.shape[0]} observations "
                         f"and {start.shape[0] - 1} cameras, not {M} and "
                         f"{n_cams}")
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    _check_vec("u", u, (2, M), torch.float32)
    _check_vec("zp", zp, (zp.shape[0], 3), torch.float32)
    dev = jc.device
    if M == 0:
        return (torch.zeros((n_cams, 6), dtype=torch.float32, device=dev),
                torch.zeros((2 * P, 2), dtype=torch.float32, device=dev))
    # stage B writes yc and yg whole; the workspaces come with the index
    yc = torch.empty((n_cams, 6), dtype=torch.float32, device=dev)
    yg = torch.empty((2 * P, 2), dtype=torch.float32, device=dev)
    from ... import _kernels
    name = f"schur_pass2_{_SUFFIX[jc.dtype]}"
    fn = getattr(_kernels.library(), name)
    err = fn(jc.data_ptr(), ji.data_ptr(), jp.data_ptr(),
             *_strides(jc, ji, jp), obs_pt.data_ptr(), u.data_ptr(),
             zp.data_ptr(), order.data_ptr(), start.data_ptr(),
             y_work.data_ptr(), g_work.data_ptr(), yc.data_ptr(),
             yg.data_ptr(), M, P, n_cams, g_work.shape[0],
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    count_dispatch("schur_pass2")
    return yc, yg


# ---------------------------------------------------------------------------
# the normal-equation blocks sweep (make_blocks): the counterpart of
# pallas_matvec.FusedBlocks

def blocks_plain(jc, ji, jp, r, obs_cam, obs_pt, n_cams, n_pts):
    """The undamped normal-equation blocks of one observation sweep, in
    the inputs' type. jc (M, 12), ji (M, 2P), jp (M, 6), r (M, 2).
    Returns pt (n_pts, 12) = [Hpp9 | gp3] per point, cam (n_cams, 42) =
    [Hcc36 | gc6] per camera, X = jiᵀji (2P, 2P), Y = jiᵀr (2P, 2)."""
    M = jc.shape[0]
    jc3, jp3 = jc.reshape(M, 2, 6), jp.reshape(M, 2, 3)
    pt_m = torch.cat([torch.einsum("mka,mkb->mab", jp3, jp3).reshape(M, 9),
                      torch.einsum("mka,mk->ma", jp3, r)], dim=1)
    pt = torch.zeros((n_pts, 12), dtype=jc.dtype, device=jc.device)
    pt.index_add_(0, obs_pt, pt_m)
    cam_m = torch.cat([torch.einsum("mka,mkb->mab", jc3, jc3).reshape(M, 36),
                       torch.einsum("mka,mk->ma", jc3, r)], dim=1)
    cam = torch.zeros((n_cams, 42), dtype=jc.dtype, device=jc.device)
    cam.index_add_(0, obs_cam, cam_m)
    return pt, cam, ji.T @ ji, ji.T @ r


def _check_blocks_inputs(jc, ji, jp, r):
    M = jc.shape[0]
    shapes = {"jc": (jc, 12), "jp": (jp, 6), "r": (r, 2)}
    for name, (t, F) in shapes.items():
        if t.dim() != 2 or tuple(t.shape) != (M, F):
            raise ValueError(f"{name} must be ({M}, {F}), got "
                             f"{tuple(t.shape)}")
    if ji.dim() != 2 or ji.shape[0] != M or ji.shape[1] % 2:
        raise ValueError(f"ji must be ({M}, 2P), got {tuple(ji.shape)}")
    P = ji.shape[1] // 2
    if not 1 <= P <= 10:
        raise ValueError(f"P={P} outside 1..10")
    for name, t in (("jc", jc), ("ji", ji), ("jp", jp), ("r", r)):
        if t.dtype != torch.float32:
            raise TypeError(f"ba_blocks takes float32, {name} is {t.dtype}")
    return M, P


def blocks(jc, ji, jp, r, obs_cam, obs_pt, n_cams, n_pts):
    """make_blocks' observation sweep (see blocks_plain). On the CPU the
    plain version runs; on CUDA tensors the ba_blocks kernel of
    csrc/ba_blocks.cu (float32 only; the inputs may be any strided (M, F)
    views), or a raise."""
    if jc.device.type == "cpu":
        return blocks_plain(jc, ji, jp, r, obs_cam, obs_pt, n_cams, n_pts)
    M, P = _check_blocks_inputs(jc, ji, jp, r)
    _check_cuda(jc, ji, jp, r, obs_cam, obs_pt)
    _check_vec("obs_cam", obs_cam, (M,), torch.int32)
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    dev = jc.device
    pt = torch.zeros((n_pts, 12), dtype=torch.float32, device=dev)
    cam = torch.zeros((n_cams, 42), dtype=torch.float32, device=dev)
    X = torch.zeros((2 * P, 2 * P), dtype=torch.float32, device=dev)
    Y = torch.zeros((2 * P, 2), dtype=torch.float32, device=dev)
    if M == 0:
        return pt, cam, X, Y
    from ... import _kernels
    err = _kernels.library("ba_blocks").ba_blocks_f32(
        jc.data_ptr(), ji.data_ptr(), jp.data_ptr(), r.data_ptr(),
        *(s for t in (jc, ji, jp, r) for s in t.stride()),
        obs_cam.data_ptr(), obs_pt.data_ptr(), pt.data_ptr(), cam.data_ptr(),
        X.data_ptr(), Y.data_ptr(), M, P, n_cams,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ba_blocks_f32")
    count_dispatch("ba_blocks")
    return pt, cam, X, Y


def blocks_camera_path(n_cams: int, P: int = 1) -> str:
    """Which camera reduction ba_blocks uses on the current CUDA device for
    this many cameras: "shared" (per-block shared-memory partials) or
    "global" (atomics straight into device memory)."""
    from ... import _kernels
    flag = _kernels.library("ba_blocks").ba_blocks_shared_cams(n_cams, P)
    _raise_on(-flag if flag < 0 else 0, "ba_blocks_shared_cams")
    return "shared" if flag else "global"
