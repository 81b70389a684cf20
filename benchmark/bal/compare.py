"""The numbers that decide a BAL cell's `correct`, worked out in float64
from the generated observations, a solve's answer and the reference's.

Per solve of the window, against the minimum of the same observations
that the reference finds:

* `cost_gap`: |reported final cost - the same cost worked out here from
  the returned parameters| / the latter. The solver reports
  1/2 sum rho'(s) s (its IRLS weight squared times the squared residual,
  1e8 for an observation behind its camera); this checks the cost it
  returns against the parameters it returns.
* `excess_cost`: Huber's cost of the returned parameters over Huber's
  cost at the reference's minimum, less 1: how far short of the minimum
  the solve stopped.
* `pixel_gap`: the root mean square, over the observations, of the
  distance between the pixel the returned parameters predict and the
  one the reference's answer predicts. Projections do not change under
  the similarity transforms that leave the problem's cost unchanged, so
  this compares the returned extrinsics, intrinsics and points whole
  without fixing a gauge.
* `pixel_gap_max`: the largest of those distances.
"""
from __future__ import annotations

import torch

from . import camera
from .reference import CHUNK, huber_cost

NUMBERS = ("cost_gap", "excess_cost", "pixel_gap", "pixel_gap_max")


def reported_cost(obs, extr, intr, pts, a):
    """The solver's stated final cost, 1/2 sum rho'(s) s."""
    total = torch.zeros((), dtype=torch.float64, device=extr.device)
    for s in range(0, obs.cam.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        r, behind = camera.residuals(extr[obs.cam[sl]], intr[obs.grp[sl]],
                                     pts[obs.pt[sl]], obs.pix[sl])
        sq = torch.sum(r * r, dim=-1)
        per = camera.huber_weight(sq, a) ** 2 * sq
        total += 0.5 * torch.sum(torch.where(behind,
                                             torch.full_like(sq, 1e8), per))
    return total


def pixels(obs, extr, intr, pts):
    out = torch.empty(obs.cam.shape[0], 2, dtype=torch.float64,
                      device=extr.device)
    for s in range(0, obs.cam.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        out[sl] = camera.project(extr[obs.cam[sl]], intr[obs.grp[sl]],
                                 pts[obs.pt[sl]])[0]
    return out


class Judge:
    """Holds the reference's answer and reads each solve's numbers."""

    def __init__(self, obs, reference_answer, loss_scale):
        self.obs, self.a = obs, loss_scale
        extr, intr, pts = (x.double() for x in reference_answer)
        self.ref_cost = float(huber_cost(obs, extr, intr, pts, loss_scale))
        self.ref_pixels = pixels(obs, extr, intr, pts)

    def numbers(self, extr, intr, pts, reported):
        """The solve's numbers; a non-finite answer reads inf."""
        dev = self.ref_pixels.device
        extr, intr, pts = (x.to(dev, torch.float64) for x in
                           (extr, intr, pts))
        if not all(bool(torch.isfinite(x).all()) for x in (extr, intr, pts)):
            return {k: float("inf") for k in NUMBERS}
        stated = float(reported_cost(self.obs, extr, intr, pts, self.a))
        cost = float(huber_cost(self.obs, extr, intr, pts, self.a))
        d = pixels(self.obs, extr, intr, pts) - self.ref_pixels
        d2 = torch.sum(d * d, dim=-1)
        out = {"cost_gap": abs(float(reported) - stated) / stated,
               "excess_cost": cost / self.ref_cost - 1.0,
               "pixel_gap": float(torch.sqrt(torch.mean(d2))),
               "pixel_gap_max": float(torch.sqrt(torch.max(d2)))}
        return {k: (v if v == v else float("inf")) for k, v in out.items()}
