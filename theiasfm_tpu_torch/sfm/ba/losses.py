"""Robust loss functions for IRLS-style bundle adjustment (port of
theiasfm_tpu/sfm/ba/losses.py).

Each loss contributes sqrt(rho'(s)) as a per-observation IRLS weight on
residuals and jacobians (first-order robustification, Triggs correction
omitted).
"""
from __future__ import annotations

import torch

LOSSES = ("trivial", "huber", "softl1", "cauchy", "arctan", "tukey")


def robust_weight(loss: str, s, scale: float):
    """sqrt(rho'(s)) for squared-norm input s = ||r||^2, scale a."""
    a2 = scale * scale
    if loss == "trivial":
        return torch.ones_like(s)
    if loss == "huber":
        # rho' = 1 if s <= a2 else a/sqrt(s)
        return torch.where(
            s <= a2, torch.ones_like(s),
            torch.sqrt(scale / torch.sqrt(torch.clamp(s, min=1e-30))))
    if loss == "softl1":
        # rho = 2 a ( sqrt(1 + s/a2) - 1 ); rho' = 1/sqrt(1 + s/a2)
        return (1.0 + s / a2) ** -0.25
    if loss == "cauchy":
        # rho = a2 log(1 + s/a2); rho' = 1/(1 + s/a2)
        return torch.sqrt(1.0 / (1.0 + s / a2))
    if loss == "arctan":
        # rho = a atan(s/a); rho' = 1/(1 + (s/a)^2)
        t = s / a2
        return torch.sqrt(1.0 / (1.0 + t * t))
    if loss == "tukey":
        t = s / a2
        w = torch.where(t <= 1.0, 1.0 - t, torch.zeros_like(t))
        return torch.sqrt(torch.clamp(w, min=0.0))
    raise ValueError(loss)
