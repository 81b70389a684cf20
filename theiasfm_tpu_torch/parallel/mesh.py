"""Multi-device bundle adjustment on torch.distributed: the mesh, and the
observation-sharded solver (port of theiasfm_tpu/parallel/mesh.py).

JAX runs one controller over a mesh of devices: `shard_map` and the
shardings place the work, and XLA inserts the psums. Here every rank is
a process (or, on the CPU, a thread) that calls the same function with
the same global inputs (SPMD, the `torchrun` idiom), takes its own
shard, and all-reduces where JAX psums; every rank returns the same
global result.

  * `Mesh` names this rank's process group along each mesh axis, the
    rank's place in the mesh and its `torch.device`. `bind()` binds the
    axis names for utils/collectives.psum, as `shard_map` binds them.
  * The observation-sharded solver (`sharded_bundle_adjust`): the
    observations (the M-axis) are split into equal slices, cameras,
    intrinsics and points are replicated, and every reduction over
    observations is all-reduced: the camera and group sums and the cost
    as in the point-sharded solver, and the point sums too (XLA's
    implicit psums in JAX). Per CG iteration that moves O(Nc * 6 + Np *
    3) values, independent of M; point_sharded.py keeps the point sums
    local.

Groups come from torch.distributed: the default group, a group the
caller built, or gloo groups over a store (`gloo_mesh`; parallel/ranks.py
starts ranks that way). NCCL refuses two ranks on one card, so several
ranks on one card go through gloo, which stages CUDA tensors through
host memory.
"""
from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
import torch
import torch.distributed as dist

from ..sfm.ba import BAOptions, BAProblem
from ..sfm.ba.bundle_adjustment import _bundle_adjust
from ..utils import collectives
from ..utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "gloo_mesh", "shard_ba_problem",
           "sharded_bundle_adjust"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a device mesh: its process group along each
    axis (for a 2-D ("dcn", "ici") mesh, the column group, whose ranks
    share the "ici" index, and the row group), and its device."""
    axis_names: tuple
    groups: tuple
    device: torch.device

    @property
    def shape(self) -> tuple:
        return tuple(g.size() for g in self.groups)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        """This rank's index in the mesh, row-major over the axes (the
        order of `np.asarray(devices).reshape(shape)` in JAX)."""
        return int(np.ravel_multi_index(
            tuple(g.rank() for g in self.groups), self.shape))

    def bind(self):
        """Bind the axis names to their groups for the length of a
        `with` block (utils/collectives.bind_axes)."""
        return collectives.bind_axes(dict(zip(self.axis_names,
                                              self.groups)))

    def check_axes(self, axis_name):
        """Raise unless `axis_name` names the mesh's axes, in order (the
        solvers shard over the whole mesh)."""
        if collectives.axis_names(axis_name) != self.axis_names:
            raise ValueError(f"axis_name {axis_name!r} does not name the "
                             f"mesh's axes {self.axis_names}")


def make_mesh(devices=None, axis_name="obs", group=None) -> Mesh:
    """This rank's mesh. devices: this rank's device (default "cuda";
    "cpu" for the tests). axis_name: one name, or a tuple of names for a
    mesh of several axes. group: the process group of a 1-D mesh
    (default: the default group, which must be initialized), or a tuple
    of groups, one per axis."""
    device = resolve_device("cuda" if devices is None else devices)
    names = collectives.axis_names(axis_name)
    if group is None:
        if len(names) != 1:
            raise ValueError(f"a mesh with axes {names} needs one group per "
                             "axis")
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh: no process group given and torch.distributed "
                "is not initialized (call init_process_group, or pass "
                "group=)")
        group = dist.group.WORLD
    groups = tuple(group) if isinstance(group, (tuple, list)) else (group,)
    if len(groups) != len(names):
        raise ValueError(f"{len(groups)} groups for the axes {names}")
    return Mesh(names, groups, device)


def gloo_mesh(store, rank: int, shape, axis_name, device,
              timeout: float = 600.0, prefix: str = "mesh") -> Mesh:
    """A mesh of gloo groups over `store` (a HashStore shared by thread
    ranks, or a TCPStore) for ranks on one host: rank `rank` of a mesh
    of `shape`, row-major. Along each axis the rank joins the group of
    the ranks that share its other coordinates. The groups talk over
    the loopback interface (gloo's default device resolves the host's
    name first). Every rank must call this with the same shape, names
    and prefix."""
    names = collectives.axis_names(axis_name)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} for the axes {names}")
    coords = np.unravel_index(rank, shape)
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=timeout)
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    groups = []
    for a in range(len(shape)):
        key = ",".join(str(c) if i != a else "*"
                       for i, c in enumerate(coords))
        sub = dist.PrefixStore(f"{prefix}/{names[a]}/{key}/", store)
        groups.append(dist.ProcessGroupGloo(sub, int(coords[a]),
                                            shape[a], opts))
    return Mesh(names, tuple(groups), resolve_device(device))


_OBS_FIELDS = ("obs_cam", "obs_group", "obs_pt", "obs_pix", "obs_mask")


def shard_ba_problem(prob: BAProblem, mesh: Mesh,
                     axis_name="obs") -> BAProblem:
    """This rank's part of the problem: the observation axis padded to a
    multiple of the mesh size with masked observations (zeros, as in
    JAX), this rank's equal slice of it, and the parameters and masks
    replicated, all on the mesh's device."""
    mesh.check_axes(axis_name)
    n = mesh.size
    M = prob.obs_cam.shape[0]
    M_loc = -(-M // n)
    pad = M_loc * n - M
    lo = mesh.rank * M_loc
    dev = mesh.device

    def piece(x):
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device=x.device)])
        return x[lo:lo + M_loc].to(dev)

    def rep(x):
        return None if x is None else x.to(dev)

    return BAProblem(
        extrinsics=rep(prob.extrinsics), intrinsics=rep(prob.intrinsics),
        points=rep(prob.points),
        **{k: piece(getattr(prob, k)) for k in _OBS_FIELDS},
        cam_mask=rep(prob.cam_mask), point_mask=rep(prob.point_mask))


def sharded_bundle_adjust(prob: BAProblem, opts: BAOptions, mesh: Mesh,
                          axis_name="obs"):
    """Bundle adjust with the observations sharded over `mesh` (every
    rank calls it with the same `prob`). Returns (the input problem with
    the solved parameters, on the mesh's device; BASummary), the same on
    every rank.

    The dense-Schur solver and the fused-matvec plan are refused: both
    index the global observation order, which this layout splits (JAX
    gathers it back inside XLA); point_sharded_bundle_adjust runs the
    kernels per rank."""
    if opts.linear_solver == "dense_schur":
        raise ValueError("the observation-sharded solver runs PCG: "
                         "dense_schur needs every observation of a point on "
                         "one rank")
    if opts.pallas_matvec and prob.pmv_p0 is not None:
        raise ValueError("the observation-sharded solver takes no "
                         "fused-matvec plan (its tiles index the global "
                         "observations); use point_sharded_bundle_adjust")
    local = shard_ba_problem(prob, mesh, axis_name)
    run_opts = dataclasses.replace(opts, axis_name=axis_name)
    with mesh.bind():
        out, summary = _bundle_adjust(local, run_opts,
                                      points_replicated=True)
    return prob._replace(extrinsics=out.extrinsics,
                         intrinsics=out.intrinsics,
                         points=out.points), summary
