"""The dense Schur solver's correction blocks through the hand-written
CUDA kernels of csrc/dense_corr.cu, over a layout of the observation
pairs built once per solve.

The dense solver (`BAOptions(linear_solver="dense_schur")`) forms the
reduced camera system from every ordered pair (k, l) of observations of
one point (k == l included). For a pair the correction blocks are

    T_k U_lᵀ (6x6),  T_k Ug_lᵀ (6xP),  Tg_k Ug_lᵀ (PxP)

with U = Jcᵀ Jp, Ug = Jiᵀ Jp, T = U Hpp⁻¹[pt], Tg = Ug Hpp⁻¹[pt], summed
per camera pair (corr_cc), camera and group (corr_cg) and group pair
(corr_gg); Hcg is Jcᵀ Ji summed per camera and group. The plain build,
bundle_adjustment._dense_schur_corr, gathers the blocks of all pairs and
adds them with index_add_; this module sums them over sorted segments,
so nothing is added twice into one place and two builds give the same
bits:

    obs_pairs, layout = pair_layout(prob)          # once a solve
    corr_cc, corr_cg, corr_gg, Hcg = corr(layout, Jc12, JiP, Jp6,
                                          Hpp_inv, obs_pt, n_groups)

The layout holds the pairs sorted by camera pair (cam_k, cam_l), each
camera pair's segment of them, the segments cut into chunks of at most
CHUNK pairs, the valid observations in camera order, each camera's group
and the cameras in group order. It needs every camera's valid
observations to name one intrinsics group (every BAL and Theia
problem): then the group pair is constant inside each camera-pair
segment and the group tables are sums of the segments' partials. pair_layout reads that with the pairs' count,
in the one host read the pairs always took, and returns no layout where
it does not hold; the solver then keeps the plain build.

`corr` runs the kernels on CUDA tensors (counted under
"dense_corr_kernel"); on the CPU it runs corr_plain, the same segment
sums in PyTorch, which counts nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.dispatch import count_dispatch, host_sync
from .fused_matvec import MAX_P, _check_cuda, _check_vec, _raise_on

CHUNK = 256   # pairs a warp of the pair kernel sums at most


class PairLayout(NamedTuple):
    """The pair layout of one solve (pair_layout), int32. Segment s =
    cam_k * Nc + cam_l holds the pairs [seg_start[s], seg_start[s + 1]),
    cut into the chunks [chunk_start[s], chunk_start[s + 1]); chunk c
    holds the pairs [chunk_lo[c], chunk_lo[c + 1]), C chunks in all (the
    last ones empty)."""
    k: torch.Tensor            # (n,) first observation of each pair
    l: torch.Tensor            # (n,) second, pairs in segment order
    seg_start: torch.Tensor    # (Nc² + 1,)
    chunk_start: torch.Tensor  # (Nc² + 1,)
    chunk_lo: torch.Tensor     # (C + 1,)
    cam_order: torch.Tensor    # (M,) valid observations by camera, then
    cam_start: torch.Tensor    # (Nc + 1,)   the masked ones
    cam_group: torch.Tensor    # (Nc,) each camera's group
    grp_order: torch.Tensor    # (Nc,) cameras by group
    grp_start: torch.Tensor    # (Ng + 1,)
    chunk: int


def pair_counts(pt_idx_valid):
    """Each point's valid observations c (Np,) and the number of ordered
    pairs, sum c², on the device."""
    c = pt_idx_valid.bool().sum(1)
    return c, (c * c).sum()


def expand_pairs(pt_idx_map, pt_idx_valid, c, n):
    """The n ordered pairs (k, l) of valid observations of one point,
    int64, point by point and in slot order within a point (the order of
    torch.nonzero on the (Np, K, K) pair mask), with no host read."""
    Np, K = pt_idx_map.shape
    dev = pt_idx_map.device
    valid = pt_idx_valid.bool()
    # each point's valid observations at the front of its row; the
    # invalid slots all land in column K
    rank = torch.where(valid, valid.cumsum(1) - 1, K)
    comp = torch.zeros((Np, K + 1), dtype=torch.long, device=dev)
    comp.scatter_(1, rank, pt_idx_map.long())
    per_pt = c * c
    pt = torch.repeat_interleave(torch.arange(Np, device=dev), per_pt,
                                 output_size=n)
    q = torch.arange(n, device=dev) - (torch.cumsum(per_pt, 0) - per_pt)[pt]
    cp = c[pt]
    i = torch.div(q, cp, rounding_mode="floor")
    return comp[pt, i], comp[pt, q - i * cp]


def _starts(sorted_keys, n):
    """Where each key 0..n first appears in sorted_keys (n + 1,) int32."""
    keys = torch.arange(n + 1, dtype=sorted_keys.dtype,
                        device=sorted_keys.device)
    return torch.searchsorted(sorted_keys, keys, out_int32=True)


def pair_layout(prob):
    """The observation pairs of a BAProblem with pt_idx_map, and their
    layout for `corr`: ((k, l) int64 as _point_obs_pairs gives them,
    PairLayout or None). None where a camera's valid observations name
    more than one intrinsics group, or where the pairs or the camera
    pairs outnumber the layout's int32 ids.

    One host read (sync.point_pairs): the pairs' count, whether the
    groups follow the cameras and whether every id lies in range, read
    together (an id out of range raises ValueError). The pairs count
    under "dense.pairs"."""
    Nc, Ng = prob.extrinsics.shape[0], prob.intrinsics.shape[0]
    Np, M = prob.points.shape[0], prob.obs_cam.shape[0]
    dev = prob.obs_cam.device
    cam, grp, pt = (x.long() for x in (prob.obs_cam, prob.obs_group,
                                       prob.obs_pt))
    valid = prob.obs_mask.bool()
    slot = prob.pt_idx_valid.bool()
    idx = prob.pt_idx_map.long()
    in_range = (((cam >= 0) & (cam < Nc) & (grp >= 0) & (grp < Ng) &
                 (pt >= 0) & (pt < Np)).all() &
                (~slot | ((idx >= 0) & (idx < M))).all())
    # each camera's group: one of its valid observations' (any, when they
    # all agree, which one_group checks)
    cam_c = cam.clamp(0, max(Nc - 1, 0))
    buf = torch.zeros(Nc + 1, dtype=torch.long, device=dev)
    buf.scatter_(0, torch.where(valid, cam_c, Nc), grp)
    cam_group = buf[:Nc]
    one_group = (~valid | (grp == cam_group[cam_c])).all()
    c, n = pair_counts(slot)
    flags = torch.stack([n, one_group.long(), in_range.long()])
    with host_sync("point_pairs"):
        n, one_group, in_range = flags.tolist()
    if not in_range:
        raise ValueError("observation indices out of range")
    count_dispatch("dense.pairs", n)
    k, l = expand_pairs(idx, slot, c, n)
    chunk, S = CHUNK, Nc * Nc
    if not one_group or max(n, S) >= 2 ** 31:
        return (k, l), None
    key, order = torch.sort((cam[k] * Nc + cam[l]).int(), stable=True)
    seg_start = _starts(key, S)
    per_seg = torch.clamp((seg_start[1:] - seg_start[:-1] + chunk - 1) //
                          chunk, min=1)
    chunk_start = torch.zeros(S + 1, dtype=torch.int32, device=dev)
    chunk_start[1:] = torch.cumsum(per_seg, 0, dtype=torch.int32)
    # at most one chunk a segment beyond CHUNK pairs each: a count the host
    # knows without reading the segments; the chunks past the last
    # segment's are empty
    chunks = torch.arange(S + -(-n // chunk), dtype=torch.int32, device=dev)
    seg = torch.searchsorted(chunk_start, chunks, right=True,
                             out_int32=True) - 1
    lo = seg_start[seg] + (chunks - chunk_start[seg]) * chunk
    chunk_lo = torch.cat([torch.where(seg < S, lo, n),
                          lo.new_full((1,), n)])
    ckey, cam_order = torch.sort(torch.where(valid, cam, Nc).int(),
                                 stable=True)
    gkey, grp_order = torch.sort(cam_group.int(), stable=True)
    layout = PairLayout(
        k=k[order].int(), l=l[order].int(), seg_start=seg_start,
        chunk_start=chunk_start, chunk_lo=chunk_lo,
        cam_order=cam_order.int(), cam_start=_starts(ckey, Nc),
        cam_group=cam_group.int(), grp_order=grp_order.int(),
        grp_start=_starts(gkey, Ng), chunk=chunk)
    return (k, l), layout


def _segment_sum(x, lengths, axis=0):
    return torch.segment_reduce(x, "sum", lengths=lengths.long(), axis=axis,
                                unsafe=True)


def corr_plain(layout, Jc12, JiP, Jp6, Hpp_inv, obs_pt, n_groups):
    """The kernels' sums in PyTorch (the CPU's route of `corr`): the
    pairs' blocks summed over the layout's segments (one a camera pair),
    the camera-group and group-group blocks summed over the cameras of
    each group (b, then a), Hcg over each camera's valid observations."""
    M, P = Jc12.shape[0], JiP.shape[1] // 2
    Nc, Ng = layout.cam_group.shape[0], n_groups
    Jc3, Ji3, Jp3 = (Jc12.reshape(M, 2, 6), JiP.reshape(M, 2, P),
                     Jp6.reshape(M, 2, 3))
    H = Hpp_inv[obs_pt.long()].reshape(M, 3, 3)
    U = torch.einsum("mka,mkc->mac", Jc3, Jp3)
    Ug = torch.einsum("mkp,mkc->mpc", Ji3, Jp3)
    T, Tg = U @ H, Ug @ H
    k, l = layout.k.long(), layout.l.long()
    n = k.shape[0]
    rows = torch.cat([(T[k] @ U[l].mT).reshape(n, 36),
                      (T[k] @ Ug[l].mT).reshape(n, 6 * P),
                      (Tg[k] @ Ug[l].mT).reshape(n, P * P)], dim=1)
    pair = _segment_sum(rows, layout.seg_start[1:] - layout.seg_start[:-1])
    g_order = layout.grp_order.long()
    g_len = layout.grp_start[1:] - layout.grp_start[:-1]
    y = _segment_sum(pair[:, 36:].reshape(Nc, Nc, -1)[:, g_order],
                     g_len.expand(Nc, Ng).contiguous(), axis=1)
    gg = _segment_sum(y[g_order, :, 6 * P:], g_len)
    h_rows = torch.einsum("mka,mkb->mab", Jc3, Ji3).reshape(M, 6 * P)
    masked = M - layout.cam_start[-1:]
    h = _segment_sum(h_rows[layout.cam_order.long()], torch.cat(
        [layout.cam_start[1:] - layout.cam_start[:-1], masked]))[:Nc]
    Hcg = torch.zeros((Nc, Ng, 6 * P), dtype=Jc12.dtype, device=Jc12.device)
    Hcg[torch.arange(Nc, device=Jc12.device), layout.cam_group.long()] = h
    return (pair[:, :36].contiguous(), y[..., :6 * P].reshape(Nc, Ng, 6, P),
            gg.reshape(Ng, Ng, P, P), Hcg.reshape(Nc, Ng, 6, P))


# ---------------------------------------------------------------------------
# the CUDA wrapper

def _row_width(P):
    return -(-(18 + 3 * P) // 4) * 4


def _part_width(P):
    return -(-(36 + 6 * P + P * P) // 32) * 32


def corr(layout: PairLayout, Jc12, JiP, Jp6, Hpp_inv, obs_pt, n_groups):
    """The correction blocks and Hcg of the reduced camera system, as
    bundle_adjustment._dense_schur_corr returns them: (corr_cc (Nc*Nc,
    36), corr_cg (Nc, Ng, 6, P), corr_gg (Ng, Ng, P, P), Hcg (Nc, Ng, 6,
    P)). Jc12 (M, 12), JiP (M, 2P), Jp6 (M, 6), Hpp_inv (Np, 9) float32,
    obs_pt (M,) int32, all contiguous, the jacobians of masked
    observations zero (the solver's weights zero them).

    On the CPU corr_plain; on CUDA tensors the kernels of
    csrc/dense_corr.cu, one launch sequence on the current stream with
    no synchronisation, or a raise."""
    if Jc12.device.type == "cpu":
        return corr_plain(layout, Jc12, JiP, Jp6, Hpp_inv, obs_pt, n_groups)
    tensors = (Jc12, JiP, Jp6, Hpp_inv, obs_pt) + layout[:-1]
    _check_cuda(*tensors)
    dev = Jc12.device
    M = Jc12.shape[0]
    P = JiP.shape[1] // 2 if JiP.dim() == 2 else 0
    if not 1 <= P <= MAX_P:
        raise ValueError(f"JiP must be (M, 2P) with P in 1..{MAX_P}, got "
                         f"{tuple(JiP.shape)}")
    f32, i32 = torch.float32, torch.int32
    Nc, Ng = layout.cam_group.shape[0], n_groups
    S = Nc * Nc
    n, C = layout.k.shape[0], layout.chunk_lo.shape[0] - 1
    for name, t, shape, dtype in (
            ("Jc12", Jc12, (M, 12), f32), ("JiP", JiP, (M, 2 * P), f32),
            ("Jp6", Jp6, (M, 6), f32),
            ("Hpp_inv", Hpp_inv, (Hpp_inv.shape[0], 9), f32),
            ("obs_pt", obs_pt, (M,), i32),
            ("layout.k", layout.k, (n,), i32),
            ("layout.l", layout.l, (n,), i32),
            ("layout.seg_start", layout.seg_start, (S + 1,), i32),
            ("layout.chunk_start", layout.chunk_start, (S + 1,), i32),
            ("layout.chunk_lo", layout.chunk_lo, (C + 1,), i32),
            ("layout.cam_order", layout.cam_order, (M,), i32),
            ("layout.cam_start", layout.cam_start, (Nc + 1,), i32),
            ("layout.cam_group", layout.cam_group, (Nc,), i32),
            ("layout.grp_order", layout.grp_order, (Nc,), i32),
            ("layout.grp_start", layout.grp_start, (Ng + 1,), i32)):
        _check_vec(name, t, shape, dtype)
    # the kernels write every output whole
    corr_cc = torch.empty((Nc * Nc, 36), dtype=f32, device=dev)
    corr_cg = torch.empty((Nc, Ng, 6, P), dtype=f32, device=dev)
    corr_gg = torch.empty((Ng, Ng, P, P), dtype=f32, device=dev)
    Hcg = torch.empty((Nc, Ng, 6, P), dtype=f32, device=dev)
    # scratch: the per-observation rows [T | Tg] and [U | Ug], the chunks'
    # partial blocks, the group-group blocks summed over b
    tk = torch.empty((M, _row_width(P)), dtype=f32, device=dev)
    ul = torch.empty_like(tk)
    part = torch.empty((C, _part_width(P)), dtype=f32, device=dev)
    ygg = torch.empty((Nc * Ng, P * P), dtype=f32, device=dev)
    from ... import _kernels
    err = _kernels.library("dense_corr").dense_corr_f32(
        Jc12.data_ptr(), JiP.data_ptr(), Jp6.data_ptr(), Hpp_inv.data_ptr(),
        obs_pt.data_ptr(), layout.k.data_ptr(), layout.l.data_ptr(),
        layout.chunk_start.data_ptr(), layout.chunk_lo.data_ptr(),
        layout.cam_order.data_ptr(), layout.cam_start.data_ptr(),
        layout.cam_group.data_ptr(), layout.grp_order.data_ptr(),
        layout.grp_start.data_ptr(), tk.data_ptr(), ul.data_ptr(),
        part.data_ptr(), ygg.data_ptr(),
        corr_cc.data_ptr(), corr_cg.data_ptr(), corr_gg.data_ptr(),
        Hcg.data_ptr(), M, P, Nc, Ng, C,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "dense_corr_f32")
    count_dispatch("dense_corr_kernel")
    return corr_cc, corr_cg, corr_gg, Hcg

