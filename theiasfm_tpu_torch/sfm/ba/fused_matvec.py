"""Fused observation sweeps of the bundle adjuster: the counterpart of
theiasfm_tpu/sfm/ba/pallas_matvec.py. The Schur-complement matvec of the
CG loop (pass1, pass2) and the normal-equation blocks of make_blocks
(blocks, below).

One matrix-free product S·v is two sweeps over the observations with a
small torch step between them (bundle_adjustment.solve_normal_eqs):

    u, wp  = pass1(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts, pt_index)
    zp     = Hpp^-1 wp                           (torch glue)
    yc, yg = pass2(jc, ji, jp, obs_cam, obs_pt, u, zp, n_cams, cam_index)

cam_index = camera_index(obs_cam, n_cams) is the camera index (the
observations in camera order, each camera's segment and, on CUDA, pass
2's stage-A workspaces) and pt_index = point_index(obs_pt, n_pts) the
point index (each point's segment, and the point order when obs_pt is not
sorted); both are built once per solve. On CUDA pass 1 requires the point
index, pass 2 the camera index and blocks both.

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
    """The camera index, fixed by obs_cam (see camera_index)."""
    order: torch.Tensor             # (M,) int32
    start: torch.Tensor             # (n_cams + 1,) int32
    y_work: Optional[torch.Tensor]  # (M, 6) f32 on CUDA, else None
    g_work: Optional[torch.Tensor]  # (blocks, 4 MAX_P) f32 on CUDA


def camera_index(obs_cam, n_cams):
    """Pass 2's and ba_blocks' camera index: cam_order, the observations
    sorted by camera, stably, so each camera keeps point order;
    cam_start, where each camera's segment of cam_order starts
    (cam_start[-1] = M). On a CUDA device it also holds pass 2's
    workspaces: y_work, the (M, 6) rows that stage A writes and stage B
    reads, and g_work, stage A's group partials, one row per block of its
    grid (the device's cap). Every pass 2 given this index reuses them,
    so calls that share it run on one stream. On obs_cam's device."""
    dev = obs_cam.device
    order = torch.sort(obs_cam, stable=True).indices.to(torch.int32)
    start = _segment_starts(obs_cam, n_cams)
    if dev.type != "cuda":
        return CameraIndex(order, start, None, None)
    parts = _part_blocks(dev.index if dev.index is not None
                         else torch.cuda.current_device())
    f32 = torch.float32
    return CameraIndex(
        order, start,
        torch.empty((obs_cam.shape[0], 6), dtype=f32, device=dev),
        torch.empty((parts, 4 * MAX_P), dtype=f32, device=dev))


class PointIndex(NamedTuple):
    """The point index, fixed by obs_pt (see point_index)."""
    order: Optional[torch.Tensor]   # (M,) int32; None when obs_pt is sorted
    start: torch.Tensor             # (n_pts + 1,) int32


def point_index(obs_pt, n_pts):
    """Pass 1's and ba_blocks' point index: start, where each point's
    segment of the point order begins (start[-1] = M), and order, the
    observations sorted by point, stably, or None when obs_pt is already
    sorted (the solver's case: MatvecPlan requires it), where the point
    order is the storage order. On obs_pt's device; one host sync."""
    M = obs_pt.shape[0]
    is_sorted = M < 2 or bool((obs_pt[1:] >= obs_pt[:-1]).all())
    order = (None if is_sorted else
             torch.sort(obs_pt, stable=True).indices.to(torch.int32))
    return PointIndex(order, _segment_starts(obs_pt, n_pts))


def _segment_starts(ids, n):
    start = torch.zeros(n + 1, dtype=torch.int32, device=ids.device)
    start[1:] = torch.cumsum(torch.bincount(ids.long(), minlength=n), 0)
    return start


def _segment_sums(y, order, start):
    lengths = (start[1:] - start[:-1]).long()
    rows = y if order is None else y[order.long()]
    return torch.segment_reduce(rows, "sum", lengths=lengths, unsafe=True)


def camera_sums_plain(y, cam_index):
    """Plain version of the kernels' camera sums (pass 2's stage B,
    ba_blocks' camera sweep): the (M, F) rows of y summed per camera over
    the segments of cam_index, (n_cams, F)."""
    return _segment_sums(y, cam_index.order, cam_index.start)


def point_sums_plain(y, pt_index):
    """Plain version of the kernels' point sums (pass 1's wp, ba_blocks'
    point sweep): the (M, F) rows of y summed per point over the segments
    of pt_index, (n_pts, F)."""
    return _segment_sums(y, pt_index.order, pt_index.start)


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


def _camera_segments(cam_index, jc, M, n_cams, who):
    """The camera index's (order, start), checked against the call (jc's
    device, M observations, n_cams cameras)."""
    if not isinstance(cam_index, CameraIndex):
        raise ValueError(f"{who} on CUDA takes cam_index=camera_index("
                         "obs_cam, n_cams), built once per solve")
    order, start = cam_index.order, cam_index.start
    _check_cuda(jc, order, start)
    _check_vec("cam_index.order", order, (M,), torch.int32)
    _check_vec("cam_index.start", start, (n_cams + 1,), torch.int32)
    return order, start


def _point_segments(pt_index, jc, M, n_pts, who):
    """The point index's (order or None, start), checked against the
    call (jc's device, M observations, n_pts points)."""
    if not isinstance(pt_index, PointIndex):
        raise ValueError(f"{who} on CUDA takes pt_index=point_index("
                         "obs_pt, n_pts), built once per solve")
    order, start = pt_index
    _check_cuda(jc, start)
    if order is not None:
        _check_cuda(jc, order)
        _check_vec("pt_index.order", order, (M,), torch.int32)
    _check_vec("pt_index.start", start, (n_pts + 1,), torch.int32)
    return order, start


# pass 1's input layouts (csrc/schur_matvec.cu)
_ANY_STRIDES, _COLUMNS = 0, 1


def _pass1_layout(jc, ji, jp, obs_cam, M):
    """_COLUMNS when every jacobian row is contiguous along M and aligned
    to 4 values (the transposed layout), M % 4 == 0 and obs_cam is aligned
    to 16 bytes: the kernel then reads four consecutive observations per
    thread in storage order, so they must be sorted by point (the
    caller's part). Else _ANY_STRIDES."""
    if M % 4 or obs_cam.data_ptr() % 16:
        return _ANY_STRIDES
    es = jc.element_size()
    if all(t.stride(1) == 1 and t.stride(0) % 4 == 0 and
           t.data_ptr() % (4 * es) == 0 for t in (jc, ji, jp)):
        return _COLUMNS
    return _ANY_STRIDES


def pass1(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts, pt_index=None):
    """First sweep of S·v. Returns (u (2, M) f32, wp (n_pts, 3) f32).
    pt_index: point_index(obs_pt, n_pts), required on CUDA, where the
    kernel sums wp over its segments (a solve builds it once); the CPU
    path ignores it."""
    if jc.device.type == "cpu":
        return pass1_plain(jc, ji, jp, obs_cam, obs_pt, vc, vg, n_pts)
    M, P = _check_jacobians(jc, ji, jp)
    _check_cuda(jc, ji, jp, obs_cam, obs_pt, vc, vg)
    Nc = vc.shape[0]
    _check_vec("obs_cam", obs_cam, (M,), torch.int32)
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    _check_vec("vc", vc, (Nc, 6), torch.float32)
    _check_vec("vg", vg, (P,), torch.float32)
    order, start = _point_segments(pt_index, jc, M, n_pts, "pass1")
    dev = jc.device
    u = torch.empty((2, M), dtype=torch.float32, device=dev)
    if M == 0:
        return u, torch.zeros((n_pts, 3), dtype=torch.float32, device=dev)
    # the kernel writes u and wp whole
    wp = torch.empty((n_pts, 3), dtype=torch.float32, device=dev)
    layout = (_pass1_layout(jc, ji, jp, obs_cam, M) if order is None
              else _ANY_STRIDES)
    from ... import _kernels
    name = f"schur_pass1_{_SUFFIX[jc.dtype]}"
    fn = getattr(_kernels.library(), name)
    err = fn(jc.data_ptr(), ji.data_ptr(), jp.data_ptr(),
             *_strides(jc, ji, jp), layout, obs_cam.data_ptr(),
             None if order is None else order.data_ptr(), start.data_ptr(),
             vc.data_ptr(), vg.data_ptr(), u.data_ptr(), wp.data_ptr(),
             M, P, n_pts, torch.cuda.current_stream(dev).cuda_stream)
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
    if isinstance(cam_index, CameraIndex) and cam_index.y_work is None:
        raise ValueError("pass2 on CUDA takes the camera index built on "
                         "the card (it holds stage A's workspaces)")
    order, start = _camera_segments(cam_index, jc, M, n_cams, "pass2")
    y_work, g_work = cam_index.y_work, cam_index.g_work
    _check_cuda(jc, y_work, g_work)
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


def _blocks_rows(jc, ji, jp, r):
    """Whether every input's (M, F) rows are contiguous and aligned for
    the kernel's loads of 4 values (F a multiple of 4) or 2."""
    def fits(t):
        vec = 4 if t.shape[1] % 4 == 0 else 2
        return (t.stride(1) == 1 and t.stride(0) % vec == 0 and
                t.data_ptr() % (4 * vec) == 0)
    return all(fits(t) for t in (jc, ji, jp, r))


def blocks(jc, ji, jp, r, obs_cam, obs_pt, n_cams, n_pts, cam_index=None,
           pt_index=None):
    """make_blocks' observation sweep (see blocks_plain). On the CPU the
    plain version runs and the indices are not used; on CUDA tensors the
    ba_blocks kernel of csrc/ba_blocks.cu (float32 only; the inputs may be
    any strided (M, F) views), which sums over the segments of cam_index =
    camera_index(obs_cam, n_cams) and pt_index = point_index(obs_pt,
    n_pts), both required (a solve builds them once), or a raise."""
    if jc.device.type == "cpu":
        return blocks_plain(jc, ji, jp, r, obs_cam, obs_pt, n_cams, n_pts)
    M, P = _check_blocks_inputs(jc, ji, jp, r)
    _check_cuda(jc, ji, jp, r, obs_cam, obs_pt)
    _check_vec("obs_cam", obs_cam, (M,), torch.int32)
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    cam_order, cam_start = _camera_segments(cam_index, jc, M, n_cams,
                                            "blocks")
    pt_order, pt_start = _point_segments(pt_index, jc, M, n_pts, "blocks")
    dev = jc.device
    f32 = torch.float32
    if M == 0:
        return (torch.zeros((n_pts, 12), dtype=f32, device=dev),
                torch.zeros((n_cams, 42), dtype=f32, device=dev),
                torch.zeros((2 * P, 2 * P), dtype=f32, device=dev),
                torch.zeros((2 * P, 2), dtype=f32, device=dev))
    # the kernels write every output whole
    pt = torch.empty((n_pts, 12), dtype=f32, device=dev)
    cam = torch.empty((n_cams, 42), dtype=f32, device=dev)
    X = torch.empty((2 * P, 2 * P), dtype=f32, device=dev)
    Y = torch.empty((2 * P, 2), dtype=f32, device=dev)
    # the point sweep's group partials (X's upper triangle, Y), one row
    # per block of 256 points
    g_work = torch.empty((-(-n_pts // 256), P * (2 * P + 1) + 4 * P),
                         dtype=f32, device=dev)
    from ... import _kernels
    err = _kernels.library("ba_blocks").ba_blocks_f32(
        jc.data_ptr(), ji.data_ptr(), jp.data_ptr(), r.data_ptr(),
        *(s for t in (jc, ji, jp, r) for s in t.stride()),
        int(_blocks_rows(jc, ji, jp, r)),
        None if pt_order is None else pt_order.data_ptr(),
        pt_start.data_ptr(), cam_order.data_ptr(), cam_start.data_ptr(),
        g_work.data_ptr(), pt.data_ptr(), cam.data_ptr(), X.data_ptr(),
        Y.data_ptr(), M, P, n_pts, n_cams,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ba_blocks_f32")
    count_dispatch("ba_blocks")
    return pt, cam, X, Y
