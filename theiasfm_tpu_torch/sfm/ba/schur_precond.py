"""The SCHUR_JACOBI preconditioner's correction blocks through the
hand-written CUDA kernel of csrc/schur_precond.cu.

For observation m, with the jacobians Jc (2x6), Ji (2xP), Jp (2x3) in the
matvec type and H = Hpp⁻¹[pt_m],

    U = Jcᵀ Jp,  Ug = Jiᵀ Jp,  T = U H,  Tg = Ug H

(H, U, Ug, T and Tg rounded to the matvec type, as the plain build rounds
them), and the blocks are summed per camera and per intrinsics group:

    corr_cc[cam]   = Σ T Uᵀ     (Nc, 6, 6)
    corr_gg[group] = Σ Tg Ugᵀ   (Ng, P, P)

The solver subtracts them from the damped Hcc and Hgg and inverts the
result (bundle_adjustment.solve_normal_eqs, build_precond):

    corr_cc, corr_gg = corr(jc, ji, jp, obs_pt, Hpp_inv, n_cams, n_groups,
                            cam_index, grp_index)

The jacobians are the (F, M) views the Schur-product kernels read (a
(12, M), a (2P, M) and a (6, M) tensor, f32 or bf16, any strides);
cam_index = fused_matvec.camera_index(obs_cam, n_cams) and, with more
than one group, grp_index = fused_matvec.group_index(obs_group, n_groups,
P), both built once per solve. Every sum runs over their segments in a
fixed order (with one group, over all observations), and only the upper
triangle of each block is summed, then stored mirrored; so nothing is
added twice into one place and two builds give the same bits.

`corr` runs the kernel on CUDA tensors (counted under "precond_kernel")
and raises on what it does not take; on the CPU it runs corr_plain, the
same arithmetic in PyTorch, which counts nothing.
"""
from __future__ import annotations

import torch

from ...utils.dispatch import count_dispatch
from .fused_matvec import (GroupIndex, _SUFFIX, _camera_segments,
                           _check_cuda, _check_jacobians, _check_vec,
                           _raise_on, _segment_sums, _strides, round_mv)

CAM_ROW = 24          # stage A's row of a 6x6 upper triangle (21 values)
BLOCK = 256           # observations a block of stage A (one partial row)


def _group_row(P):
    """Stage A's row of a PxP upper triangle: P(P+1)/2 values, padded to
    a multiple of 4."""
    return (P * (P + 1) // 2 + 3) // 4 * 4


def _mirror(upper, S):
    """(n, S(S+1)/2) upper triangles, row by row -> (n, S, S) symmetric."""
    r, c = torch.triu_indices(S, S, device=upper.device)
    out = upper.new_zeros((upper.shape[0], S, S))
    out[:, r, c] = upper
    out[:, c, r] = upper
    return out


def corr_plain(jc, ji, jp, obs_pt, hpp_inv, n_cams, n_groups, cam_index,
               grp_index=None):
    """The kernel's arithmetic in PyTorch (see the module's docstring):
    (corr_cc (n_cams, 6, 6), corr_gg (n_groups, P, P)), float32, summed
    over the segments of cam_index and, with n_groups > 1, grp_index."""
    mv, f32 = jc.dtype, torch.float32
    M, P = jc.shape[1], ji.shape[0] // 2
    x = torch.cat([jc.to(f32).reshape(2, 6, M), ji.to(f32).reshape(2, P, M)],
                  dim=1)                                     # (2, 6+P, M)
    q = jp.to(f32).reshape(2, 3, M)
    H = round_mv(hpp_inv[obs_pt.long()], mv).reshape(M, 3, 3)
    V = round_mv(torch.einsum("kam,kcm->mac", x, q), mv)     # (M, 6+P, 3)
    T = round_mv(torch.einsum("mac,mce->mae", V, H), mv)

    def upper(lo, S):
        r, c = torch.triu_indices(S, S, device=jc.device)
        return torch.sum(T[:, lo + r] * V[:, lo + c], dim=-1)

    cc = _segment_sums(upper(0, 6), cam_index.order, cam_index.start)
    gg = upper(6, P)
    if n_groups == 1:
        gg = gg.sum(dim=0, keepdim=True)
    else:
        gg = _segment_sums(gg, grp_index.order, grp_index.start)
    return _mirror(cc, 6), _mirror(gg, P)


def corr(jc, ji, jp, obs_pt, hpp_inv, n_cams, n_groups, cam_index=None,
         grp_index=None):
    """The correction blocks (corr_cc (n_cams, 6, 6), corr_gg (n_groups,
    P, P)), float32. On the CPU corr_plain; on CUDA tensors the kernel,
    which needs cam_index and, with n_groups > 1, grp_index built on the
    card for these observations, or a raise. The kernel trusts obs_pt to
    lie inside hpp_inv (the solver checks the ids once per solve)."""
    if jc.device.type == "cpu":
        return corr_plain(jc, ji, jp, obs_pt, hpp_inv, n_cams, n_groups,
                          cam_index, grp_index)
    M, P = _check_jacobians(jc, ji, jp)
    _check_cuda(jc, ji, jp, obs_pt, hpp_inv)
    _check_vec("obs_pt", obs_pt, (M,), torch.int32)
    _check_vec("hpp_inv", hpp_inv, (hpp_inv.shape[0], 9), torch.float32)
    cam_order, cam_start = _camera_segments(cam_index, jc, M, n_cams,
                                            "schur_precond.corr")
    if n_groups < 1:
        raise ValueError(f"n_groups={n_groups}: at least one group")
    grp_order = grp_start = None
    if n_groups > 1:
        if not isinstance(grp_index, GroupIndex):
            raise ValueError("schur_precond.corr on CUDA with several groups "
                             "takes grp_index=group_index(obs_group, "
                             "n_groups, P)")
        grp_order, grp_start = grp_index.order, grp_index.start
        _check_cuda(jc, grp_order, grp_start)
        _check_vec("grp_index.order", grp_order, (M,), torch.int32)
        _check_vec("grp_index.start", grp_start, (n_groups + 1,),
                   torch.int32)
    dev, f32 = jc.device, torch.float32
    # the kernel writes both outputs whole; its workspaces come from the
    # allocator's cache, for this build only
    corr_cc = torch.empty((n_cams, 6, 6), dtype=f32, device=dev)
    corr_gg = torch.empty((n_groups, P, P), dtype=f32, device=dev)
    cam_rows = torch.empty((M, CAM_ROW), dtype=f32, device=dev)
    if n_groups == 1:
        grp_rows = None
        g_part = torch.empty((-(-M // BLOCK), P * (P + 1) // 2),
                             dtype=f32, device=dev)
    else:
        grp_rows = torch.empty((M, _group_row(P)), dtype=f32, device=dev)
        g_part = None
    from ... import _kernels
    name = f"schur_precond_{_SUFFIX[jc.dtype]}"
    fn = getattr(_kernels.library("schur_precond"), name)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = fn(jc.data_ptr(), ji.data_ptr(), jp.data_ptr(),
             *_strides(jc, ji, jp), obs_pt.data_ptr(), hpp_inv.data_ptr(),
             cam_order.data_ptr(), cam_start.data_ptr(), ptr(grp_order),
             ptr(grp_start), cam_rows.data_ptr(), ptr(grp_rows), ptr(g_part),
             corr_cc.data_ptr(), corr_gg.data_ptr(), M, P, n_cams, n_groups,
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    count_dispatch("precond_kernel")
    return corr_cc, corr_gg
