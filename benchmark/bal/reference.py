"""The plain reference of the BAL cells: Levenberg-Marquardt bundle
adjustment with the Schur complement and preconditioned CG, written from
the textbook in plain torch, in float64 on whatever device it is given.

It imports nothing of the program under test and takes nothing the
program made: it gets the benchmark's generated observations, the
intrinsics start and a solve's starting state, and works out everything
else (padding has no meaning here, the jacobians, the blocks, the
preconditioner) itself.

The problem is the configuration's: IRLS under Huber's loss (weights
sqrt(rho'(s)); an observation behind its camera costs 1e8, as the
solver's stated cost has it), LM with the damping lambda * diag(H),
accepted steps multiplying lambda by 0.33 and rejected ones by 10, one
step per LM iteration from the reduced camera-and-intrinsics system,
then point-wise Gauss-Newton inner iterations guarded per point, for the
traffic's number of LM iterations. Steps are accepted on Huber's cost,
1/2 sum rho(s).

The linear solves are the reference's own: CG with the Schur
complement's diagonal blocks as preconditioner, to a relative residual
of CG_ETA, with the gauge held (see `gauge`). The result is LM's own
step, whatever stopping rule the program's solver uses.

Per-observation rows are summed per point, camera and group by segment
sums over chunks (the observations come sorted by point; `cam_order`
sorts them by camera, and the camera-side rows are formed in that
order), so no block is ever formed for all observations at once.

`solve(..., dtype=torch.bfloat16)` is the lower-precision control: the
same algorithm with every value held and computed in bfloat16 (sums
accumulate in float32 and the small dense inverses are taken in float32,
each rounded back, since torch's segment sums and linear algebra take no
bfloat16).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import camera

CHUNK = 1 << 21
# each damped system is solved to this relative residual, in at most
# CG_ITERATIONS iterations
CG_ETA = 1e-2
CG_ITERATIONS = 200
# the cost of an observation behind its camera
BEHIND = 1e8


@dataclasses.dataclass(frozen=True)
class Options:
    iterations: int
    loss_scale: float
    initial_lambda: float
    min_lambda: float
    max_lambda: float
    inner_iterations: int
    active: tuple          # the optimised intrinsics slots

    @classmethod
    def from_config(cls, config: dict, iterations: int) -> "Options":
        s = config["solver"]
        if s["loss"] != "huber":
            raise ValueError("the reference implements Huber's loss only")
        return cls(iterations=iterations, loss_scale=s["loss_scale"],
                   initial_lambda=s["initial_lambda"],
                   min_lambda=s["min_lambda"], max_lambda=s["max_lambda"],
                   inner_iterations=s["inner_iterations"],
                   active=tuple(config["optimize_intrinsics"]))


def _seg(rows, lengths):
    """Segment sums of (n, ...) rows over consecutive segments."""
    dt = rows.dtype
    if dt == torch.bfloat16:
        rows = rows.float()
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                unsafe=True, initial=0).to(dt)


def _chunks(ids):
    """(slice, lo, hi, segment lengths) of each chunk of ascending ids."""
    out = []
    M = ids.shape[0]
    for s in range(0, M, CHUNK):
        sl = slice(s, min(s + CHUNK, M))
        k = ids[sl]
        lo, hi = (int(v) for v in torch.stack([k[0], k[-1]]).tolist())
        out.append((sl, lo, hi, torch.bincount(k - lo,
                                               minlength=hi - lo + 1)))
    return out


@dataclasses.dataclass
class Observations:
    """The observations in the reference's own types (unmasked only), in
    point order, and what summing per point and per camera takes."""
    cam: torch.Tensor          # (M,) int64
    grp: torch.Tensor          # (M,) int64
    pt: torch.Tensor           # (M,) int64, non-decreasing
    pix: torch.Tensor          # (M, 2)
    n_cams: int
    n_groups: int
    n_pts: int
    groups: str                # "shared", or "cameras": one each
    cam_order: torch.Tensor    # (M,) the observations in camera order
    pt_by_cam: torch.Tensor    # (M,) pt[cam_order]
    pt_chunks: list
    cam_chunks: list

    @classmethod
    def of(cls, scene, dtype=torch.float64) -> "Observations":
        keep = scene.obs_mask
        cam, grp, pt = (x[keep].long() for x in
                        (scene.obs_cam, scene.obs_group, scene.obs_pt))
        if pt.numel() > 1 and not bool((pt[1:] >= pt[:-1]).all()):
            raise ValueError("the reference takes observations sorted by "
                             "point")
        n_cams, n_groups = (scene.extrinsics.shape[0],
                            scene.intrinsics.shape[0])
        if n_groups == 1:
            groups = "shared"
        elif n_groups == n_cams and torch.equal(grp, cam):
            groups = "cameras"
        else:
            raise ValueError("the reference takes one intrinsics group for "
                             "all cameras or one for each")
        order = torch.sort(cam, stable=True).indices
        return cls(cam=cam, grp=grp, pt=pt, pix=scene.obs_pix[keep].to(dtype),
                   n_cams=n_cams, n_groups=n_groups,
                   n_pts=scene.points.shape[0], groups=groups,
                   cam_order=order, pt_by_cam=pt[order],
                   pt_chunks=_chunks(pt), cam_chunks=_chunks(cam[order]))

    def _sums(self, chunks, n, fn):
        out = None
        for sl, lo, hi, lengths in chunks:
            part = _seg(fn(sl), lengths)
            if out is None:
                out = torch.zeros((n,) + part.shape[1:], dtype=part.dtype,
                                  device=part.device)
            out[lo:hi + 1] += part
        return out

    def point_sums(self, fn):
        """fn(slice) -> rows of those observations in point order (the
        storage order), summed per point."""
        return self._sums(self.pt_chunks, self.n_pts, fn)

    def camera_sums(self, fn):
        """fn(slice) -> rows of those observations in camera order (of
        arrays indexed by `cam_order`), summed per camera."""
        return self._sums(self.cam_chunks, self.n_cams, fn)

    def shared_sum(self, fn):
        """fn(slice) -> rows of those observations in point order, summed
        over all of them, (1, ...): the one group's sum."""
        out = None
        for sl, _, _, _ in self.pt_chunks:
            part = fn(sl).sum(0, keepdim=True)
            out = part if out is None else out + part
        return out


def _inv(blocks):
    """Inverse of a batch of small SPD blocks (float32 for bfloat16)."""
    if blocks.dtype == torch.bfloat16:
        return torch.linalg.inv_ex(blocks.float())[0].to(blocks.dtype)
    return torch.linalg.inv_ex(blocks)[0]


def _damp(H, lam):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * d)


def _rho(r, behind, a):
    """Huber's rho of each residual, BEHIND for one behind its camera."""
    s = torch.sum(r * r, dim=-1)
    return torch.where(behind, torch.full_like(s, BEHIND),
                       camera.huber_rho(s, a))


def huber_cost(obs: Observations, extr, intr, pts, a):
    """1/2 sum rho over the observations (in the parameters' type)."""
    total = torch.zeros((), dtype=extr.dtype, device=extr.device)
    for s in range(0, obs.cam.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        r, behind = camera.residuals(extr[obs.cam[sl]], intr[obs.grp[sl]],
                                     pts[obs.pt[sl]], obs.pix[sl])
        total = total + 0.5 * torch.sum(_rho(r, behind, a))
    return total


def _point_cost(obs, extr, intr, pts, a):
    def rows(idx):
        r, behind = camera.residuals(extr[obs.cam[idx]], intr[obs.grp[idx]],
                                     pts[obs.pt[idx]], obs.pix[idx])
        return 0.5 * _rho(r, behind, a)
    return obs.point_sums(rows)


def _selector(active, dtype, device):
    E = torch.zeros(len(active), 10, dtype=dtype, device=device)
    E[torch.arange(len(active)), torch.tensor(active)] = 1.0
    return E


def linearize(obs: Observations, extr, intr, pts, opts: Options):
    """Weighted residuals r (M, 2) and jacobians Jc (M, 2, 6), Jg (M, 2, A),
    Jp (M, 2, 3) at the given state, by forward-mode differentiation of
    the projection in chunks."""
    dt, dev = extr.dtype, extr.device
    E = _selector(opts.active, dt, dev)
    keep = 1.0 - E.sum(0)

    def f(e, p, ga, g_fixed, pix):
        intr_ = g_fixed * keep + ga @ E
        return camera.residuals(e, intr_, p, pix)[0]

    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1, 2)))
    M = obs.cam.shape[0]
    r = torch.empty(M, 2, dtype=dt, device=dev)
    Jc = torch.empty(M, 2, 6, dtype=dt, device=dev)
    Jg = torch.empty(M, 2, len(opts.active), dtype=dt, device=dev)
    Jp = torch.empty(M, 2, 3, dtype=dt, device=dev)
    act = torch.tensor(opts.active, device=dev)
    for s in range(0, M, CHUNK):
        sl = slice(s, s + CHUNK)
        e, g, p = extr[obs.cam[sl]], intr[obs.grp[sl]], pts[obs.pt[sl]]
        ga = g[:, act]
        r[sl] = f(e, p, ga, g, obs.pix[sl])
        Jc[sl], Jp[sl], Jg[sl] = jac(e, p, ga, g, obs.pix[sl])
    w = camera.huber_weight(torch.sum(r * r, dim=-1), opts.loss_scale)
    for x in (r, Jc, Jg, Jp):
        x.mul_(w.reshape((M,) + (1,) * (x.dim() - 1)))
    return r, Jc, Jg, Jp


def gauge(extr):
    """(Nc, 6) 1/0 mask of the camera parameters the reference moves: all
    but the first camera's six and the scale, held by the coordinate of
    the camera farthest from it along which they lie farthest apart. The
    cost and every projection are the same under the similarity
    transforms these fix, so the reference finds the same minimum; fixed,
    they leave CG a positive definite system whatever the damping."""
    free = torch.ones_like(extr)
    free[0] = 0.0
    d = extr[:, :3] - extr[0, :3]
    far = int(torch.argmax(torch.sum(d * d, dim=-1)))
    free[far, int(torch.argmax(d[far].abs()))] = 0.0
    return free


def _tp(x):
    return x.transpose(-1, -2)


# products of small per-row matrices, written as broadcasts: elementwise
# kernels, where batched matrix products of such sizes run slowly
def _mv(A, v):
    """A v per row: (n, i, j), (n, j) -> (n, i)."""
    return (A * v[..., None, :]).sum(-1)


def _tmv(A, v):
    """A^T v per row: (n, i, j), (n, i) -> (n, j)."""
    return (A * v[..., None]).sum(-2)


def _mm(A, B):
    """A B per row: (n, i, k), (n, k, j) -> (n, i, j)."""
    out = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        out = out + A[..., :, k, None] * B[..., None, k, :]
    return out


def _blocks(obs, J, r, lam, fixed):
    """The damped system's pieces: C^-1 per point, the gradients, the
    damping and the preconditioner, the Schur complement's diagonal
    blocks: one (6+A)x(6+A) block per camera where each camera has its
    own group, else 6x6 per camera and the shared group's AxA (exact
    where a track sees a camera once; for the shared group a point's
    observations are summed first). J holds the jacobians in point order
    (`c`, `g`, `p`) and in camera order (`cam`: the camera's own columns,
    `p_cam`)."""
    Jc, Jg, Jp = J["c"], J["g"], J["p"]
    Jk, Jpk = J["cam"], J["p_cam"]
    rk = r[obs.cam_order]
    Hpp = obs.point_sums(lambda i: _mm(_tp(Jp[i]), Jp[i]))
    Cinv = _inv(_damp(Hpp, lam))
    gp = obs.point_sums(lambda i: _tmv(Jp[i], r[i]))
    gk = obs.camera_sums(lambda i: _tmv(Jk[i], rk[i]))

    def corr(i):
        U = _mm(_tp(Jk[i]), Jpk[i])
        return _mm(_mm(U, Cinv[obs.pt_by_cam[i]]), _tp(U))

    H = obs.camera_sums(lambda i: _mm(_tp(Jk[i]), Jk[i]))
    D = lam * torch.diagonal(H, dim1=-2, dim2=-1)
    pad = torch.zeros_like(D)
    pad[:, :6] = fixed
    S = _damp(H, lam) - obs.camera_sums(corr) + torch.diag_embed(pad)
    if obs.groups == "cameras":
        return (Cinv, gp, gk[:, :6], gk[:, 6:], D[:, :6], D[:, 6:],
                (_inv(S),))
    Hgg = obs.shared_sum(lambda i: _mm(_tp(Jg[i]), Jg[i]))
    gg = obs.shared_sum(lambda i: _tmv(Jg[i], r[i]))
    W = obs.point_sums(lambda i: _mm(_tp(Jg[i]), Jp[i]))
    corr_g = _mm(_mm(W, Cinv), _tp(W)).sum(0, keepdim=True)
    Dg = lam * torch.diagonal(Hgg, dim1=-2, dim2=-1)
    return (Cinv, gp, gk, gg, D, Dg,
            (_inv(S), _inv(_damp(Hgg, lam) - corr_g)))


def lm_step(obs: Observations, extr, intr, pts, lam, free, opts: Options):
    """One damped Gauss-Newton step from the state: (dc, dg, dp, CG
    iterations)."""
    r, Jc, Jg, Jp = linearize(obs, extr, intr, pts, opts)
    Jc.mul_(free[obs.cam][:, None, :])
    fixed = 1.0 - free
    own = obs.groups == "cameras"
    order = obs.cam_order
    # the camera's own columns (with its group's where it has its own) in
    # camera order, for the per-camera sums
    Jk = (torch.cat([Jc, Jg], dim=-1) if own else Jc)[order]
    J = {"c": Jc, "g": Jg, "p": Jp, "cam": Jk, "p_cam": Jp[order]}
    Cinv, gp, gc, gg, Dc, Dg, P = _blocks(obs, J, r, lam, fixed)
    del r, J

    def pt_apply(t):                       # C^-1 t per point
        return _mv(Cinv, t)

    def from_obs(d):                       # (Jc^T d, Jg^T d) summed
        dk = d[order]
        yk = obs.camera_sums(lambda i: _tmv(Jk[i], dk[i]))
        if own:
            return yk[:, :6], yk[:, 6:]
        return yk, obs.shared_sum(lambda i: _tmv(Jg[i], d[i]))

    def to_obs(vc, vg):                    # Jc vc + Jg vg per observation
        return _mv(Jc, vc[obs.cam]) + _mv(Jg, vg[obs.grp])

    def point_side(u):                     # sum per point of Jp^T u
        return obs.point_sums(lambda i: _tmv(Jp[i], u[i]))

    # b = -g + B C^-1 g_p
    tc, tg = from_obs(_mv(Jp, pt_apply(gp)[obs.pt]))
    bc, bg = tc - gc, tg - gg

    def S(vc, vg):
        u = to_obs(vc, vg)
        z = pt_apply(point_side(u))
        yc, yg = from_obs(u - _mv(Jp, z[obs.pt]))
        return yc + (Dc + fixed) * vc, yg + Dg * vg

    def precond(rc, rg):
        if len(P) == 1:
            z = _mv(P[0], torch.cat([rc, rg], 1))
            return z[:, :6], z[:, 6:]
        return (_mv(P[0], rc),
                _mv(P[1], rg))

    def dot(ac, ag, bc_, bg_):
        return torch.sum(ac * bc_) + torch.sum(ag * bg_)

    xc, xg = torch.zeros_like(bc), torch.zeros_like(bg)
    rc, rg = bc, bg
    zc, zg = precond(rc, rg)
    pc, pg = zc, zg
    rz = dot(rc, rg, zc, zg)
    tol2 = float(CG_ETA ** 2 * dot(bc, bg, bc, bg))
    it = 0
    while it < CG_ITERATIONS and float(dot(rc, rg, rc, rg)) > tol2:
        qc, qg = S(pc, pg)
        alpha = rz / dot(pc, pg, qc, qg)
        xc, xg = xc + alpha * pc, xg + alpha * pg
        rc, rg = rc - alpha * qc, rg - alpha * qg
        zc, zg = precond(rc, rg)
        rz_new = dot(rc, rg, zc, zg)
        pc, pg = zc + (rz_new / rz) * pc, zg + (rz_new / rz) * pg
        rz = rz_new
        it += 1
    # back-substitution: dp = C^-1 (-g_p - B^T x)
    dp = pt_apply(-gp - point_side(to_obs(xc, xg)))
    return xc, xg, dp, it


def inner_iterations(obs: Observations, extr, intr, pts, opts: Options):
    """Gauss-Newton on each point with the cameras fixed; a point keeps
    its update only where its own cost falls."""
    a = opts.loss_scale

    def f(p, e, g, pix):
        return camera.residuals(e, g, p, pix)[0]

    jac = torch.func.vmap(torch.func.jacfwd(f))
    cost = _point_cost(obs, extr, intr, pts, a)
    for _ in range(opts.inner_iterations):
        def rows(i, pts=pts):
            args = (pts[obs.pt[i]], extr[obs.cam[i]], intr[obs.grp[i]],
                    obs.pix[i])
            r = f(*args)
            Jp = jac(*args).to(r.dtype)
            w = camera.huber_weight(torch.sum(r * r, dim=-1), a)
            r, Jp = r * w[:, None], Jp * w[:, None, None]
            return torch.cat([_mm(_tp(Jp), Jp).reshape(-1, 9),
                              _tmv(Jp, r)], dim=1)

        hg = obs.point_sums(rows)
        H = hg[:, :9].reshape(-1, 3, 3) + 1e-10 * torch.eye(
            3, dtype=hg.dtype, device=hg.device)
        cand = pts - _mv(_inv(H), hg[:, 9:])
        new = _point_cost(obs, extr, intr, cand, a)
        better = new < cost
        pts = torch.where(better[:, None], cand, pts)
        cost = torch.where(better, new, cost)
    return pts


def solve(obs: Observations, intrinsics, extrinsics, points,
          opts: Options, dtype=torch.float64, log=None, tol=0.0):
    """The LM solve from the given start. Returns (extrinsics, intrinsics,
    points) in `dtype`; `log`, when given, gets a line per iteration. It
    stops early once an accepted step lowers the cost by less than `tol`
    of it."""
    extr, intr, pts = (x.to(dtype) for x in (extrinsics, intrinsics, points))
    if obs.pix.dtype != dtype:
        obs = dataclasses.replace(obs, pix=obs.pix.to(dtype))
    a = opts.loss_scale
    act = torch.tensor(opts.active, device=extr.device)
    lam = torch.tensor(opts.initial_lambda, dtype=torch.float64)
    cost = huber_cost(obs, extr, intr, pts, a)
    free = gauge(extr)
    for i in range(opts.iterations):
        t0 = time.perf_counter()
        dc, dg, dp, cg = lm_step(obs, extr, intr, pts, lam.to(dtype), free,
                                 opts)
        t1 = time.perf_counter()
        extr_n, pts_n = extr + dc, pts + dp
        intr_n = intr.clone()
        intr_n[:, act] += dg
        if opts.inner_iterations > 0:
            pts_n = inner_iterations(obs, extr_n, intr_n, pts_n, opts)
        new = huber_cost(obs, extr_n, intr_n, pts_n, a)
        accept = bool(new < cost)
        if log is not None:
            log(f"reference iteration {i}: {cg} CG iterations, cost "
                f"{float(new):.9g} {'accepted' if accept else 'rejected'}; "
                f"step {t1 - t0:.3f} s, inner and cost "
                f"{time.perf_counter() - t1:.3f} s")
        if accept:
            done = bool(cost - new < tol * cost)
            extr, intr, pts, cost = extr_n, intr_n, pts_n, new
            lam = torch.clamp(lam * 0.33, min=opts.min_lambda)
            if done:
                break
        else:
            lam = torch.clamp(lam * 10.0, max=opts.max_lambda)
    return extr, intr, pts
