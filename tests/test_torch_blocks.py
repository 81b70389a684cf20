"""The port's normal-equation blocks sweep (fused_matvec.blocks and its
plain version blocks_plain) against the JAX package's Pallas kernel
(pallas_matvec.FusedBlocks, run with interpret=True on the CPU), on the
same numpy inputs.

On CPU tensors the wrapper runs the plain version; the CUDA kernel
(csrc/ba_blocks.cu) is held against the plain version on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py)."""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from __graft_entry__ import _make_problem  # noqa: E402
from theiasfm_tpu.sfm.ba import bundle_adjustment as jba  # noqa: E402
from theiasfm_tpu.sfm.ba.pallas_matvec import FusedBlocks  # noqa: E402
from theiasfm_tpu.sfm.ba.pallas_matvec import MatvecPlan  # noqa: E402
from theiasfm_tpu_torch.sfm.ba import fused_matvec as fm  # noqa: E402

# every output's max abs error relative to its largest reference entry:
# both sum the same f32 products, in another order
REL = 1e-5


def _padded_inputs(P, block=512):
    """The ids of the 12-camera/250-point bench problem, padded to a
    multiple of block, and f32 jacobians and residuals, zero on the
    padding observations (their weight is 0 in build_system, which
    scales r and every J by it)."""
    jp = _make_problem(n_cams=12, n_pts=250, obs_per_pt=4,
                       dtype=jnp.float32)
    jp = jba.pad_obs_to_multiple(jp, block)
    obs_cam, obs_pt = np.asarray(jp.obs_cam), np.asarray(jp.obs_pt)
    w = np.asarray(jp.obs_mask, np.float32)[:, None]
    rng = np.random.default_rng(4)
    M = obs_cam.shape[0]
    jac = [(rng.normal(size=(M, F)) * w).astype(np.float32)
           for F in (12, 2 * P, 6, 2)]
    assert not w.all()
    return obs_cam, obs_pt, jac, 12, 250


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= REL * np.max(np.abs(ref)), err


@pytest.mark.parametrize("block", [512, 256])
def test_blocks_plain_matches_pallas(block):
    """blocks_plain against FusedBlocks in interpret mode; the TPU kernel
    returns lane-padded (Np_pad, 128) point and (cam_pad, 42) camera
    buffers, the port compact (Np, 12) and (Nc, 42)."""
    P = 1
    obs_cam, obs_pt, (Jc, Ji, Jp, r), Nc, Np = _padded_inputs(P, block)
    plan = MatvecPlan(obs_cam, obs_pt, Nc, Np, block=block)
    pt_j, cam_j, X_j, Y_j = FusedBlocks(plan, P, interpret=True)(
        *(jnp.asarray(x) for x in (Jc, Ji, Jp, r)))
    pt, cam, X, Y = fm.blocks(
        *(torch.tensor(x) for x in (Jc, Ji, Jp, r)),
        torch.tensor(obs_cam), torch.tensor(obs_pt), Nc, Np)
    assert pt.shape == (Np, 12) and cam.shape == (Nc, 42)
    _close(pt, np.asarray(pt_j)[:Np, :12])
    _close(cam, np.asarray(cam_j)[:Nc])
    _close(X, X_j)
    _close(Y, Y_j)
    # the padding rows of the TPU's buffers hold nothing
    assert not np.asarray(pt_j)[Np:, :12].any()
    assert not np.asarray(pt_j)[:, 12:].any()


@pytest.mark.parametrize("P", [1, 3])
def test_blocks_plain_matches_dense_algebra(P):
    """The plain version against the normal-equation blocks written
    densely in f64, in any observation order."""
    rng = np.random.default_rng(8)
    M, Nc, Np = 300, 7, 40
    obs_cam = rng.integers(0, Nc, M)
    obs_pt = rng.integers(0, Np, M)
    Jc, Ji, Jp, r = (rng.normal(size=(M, F)) for F in (12, 2 * P, 6, 2))
    pt, cam, X, Y = fm.blocks_plain(
        *(torch.tensor(x) for x in (Jc, Ji, Jp, r)),
        torch.tensor(obs_cam), torch.tensor(obs_pt), Nc, Np)
    Jc3, Jp3 = Jc.reshape(M, 2, 6), Jp.reshape(M, 2, 3)
    pt_ref = np.zeros((Np, 12))
    np.add.at(pt_ref, obs_pt, np.concatenate(
        [np.einsum("mka,mkb->mab", Jp3, Jp3).reshape(M, 9),
         np.einsum("mka,mk->ma", Jp3, r)], 1))
    cam_ref = np.zeros((Nc, 42))
    np.add.at(cam_ref, obs_cam, np.concatenate(
        [np.einsum("mka,mkb->mab", Jc3, Jc3).reshape(M, 36),
         np.einsum("mka,mk->ma", Jc3, r)], 1))
    for got, ref in ((pt, pt_ref), (cam, cam_ref), (X, Ji.T @ Ji),
                     (Y, Ji.T @ r)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-12)


def test_blocks_wrapper_on_other_device_raises():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    sent down the plain path."""
    M = 32
    j = [torch.zeros(M, F, device="meta") for F in (12, 2, 6, 2)]
    ids = torch.zeros(M, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        fm.blocks(*j, ids, ids, 3, 4)


@pytest.mark.parametrize("sorted_pts", [True, False],
                         ids=["sorted", "unsorted"])
def test_blocks_on_cpu_ignores_indices(sorted_pts):
    """On the CPU blocks runs its plain version: given the camera and
    point indices (which the CUDA kernel requires) or not, the same
    bits."""
    rng = np.random.default_rng(6)
    M, Nc, Np, P = 300, 7, 40, 3
    obs_cam = torch.tensor(rng.integers(0, Nc, M), dtype=torch.int32)
    obs_pt = np.sort(rng.integers(0, Np, M))
    if not sorted_pts:
        obs_pt = rng.permutation(obs_pt)
    obs_pt = torch.tensor(obs_pt, dtype=torch.int32)
    js = [torch.tensor(rng.normal(size=(M, F)), dtype=torch.float32)
          for F in (12, 2 * P, 6, 2)]
    got = fm.blocks(*js, obs_cam, obs_pt, Nc, Np,
                    cam_index=fm.camera_index(obs_cam, Nc),
                    pt_index=fm.point_index(obs_pt, Np))
    ref = fm.blocks(*js, obs_cam, obs_pt, Nc, Np)
    for g, f in zip(got, ref):
        assert torch.equal(g, f)
