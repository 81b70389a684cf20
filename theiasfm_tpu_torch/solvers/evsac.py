"""EVSAC: correctness-probability weighted sampling from extreme-value
statistics of descriptor match distances (port of
theiasfm_tpu/solvers/evsac.py).

ref: src/theia/solvers/evsac_sampler.h:66-106 (+ vendored statx), after
"EVSAC: Accelerating Hypotheses Generation by Modeling Matching Scores
using Extreme Value Theory" (Fragoso et al., ICCV 2013):

  1. MR-Rayleigh predictor (evsac_sampler.h MRRayleigh): per query, fit
     a Rayleigh to the tail of its k-NN distances; predict "correct"
     when 1 - raylcdf(d_1) >= predictor_threshold (recommended 0.65).
  2. Fit a Gamma(k, theta) by MLE to the smallest distances of the
     predicted-correct queries (statx gammafit).
  3. Fit a GEV(mu, sigma, xi) to the NEGATED second-smallest distances
     (statx gevfit): L-moment (Hosking) closed-form init + guarded
     Newton steps on the negative log-likelihood.
  4. Estimate the inlier ratio eps by the constrained least-squares fit
     of the mixture CDF to the empirical CDF of the smallest distances,
     bounded above by the predictor's positive rate (a 1-D
     box-constrained LS with a closed form).
  5. Posterior P(correct | d) = eps*gamma_pdf / (eps*gamma_pdf +
     (1-eps)*gev_rev_pdf); sampling weight = posterior * predicted.

Every function works on the last axis and is batched over the leading
ones (one problem per image pair). The weights feed the engine's
'weighted' sampler (Gumbel top-k), the batched replacement for the
reference's std::discrete_distribution; it draws from a
torch.Generator on the weights' device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import linalg
from .ransac import _gumbel


class EvsacMixtureParams(NamedTuple):
    """ref EvsacSampler::MixtureModelParams (evsac_sampler.h:139-160)."""
    gamma_k: torch.Tensor
    gamma_theta: torch.Tensor
    gev_mu: torch.Tensor
    gev_sigma: torch.Tensor
    gev_xi: torch.Tensor
    inlier_ratio: torch.Tensor


# ---------------------------------------------------------------- Rayleigh

def mr_rayleigh_predict(sorted_distances, predictor_threshold=0.65):
    """Meta-Recognition Rayleigh predictor (evsac_sampler.h MRRayleigh).

    sorted_distances: (..., N, k) ascending per-query NN distances. The
    tail (columns 1..k-1) fits sigma^2 = mean(x^2)/2 (Rayleigh MLE); the
    correctness belief is 1 - raylcdf(d_0) = exp(-d_0^2 / (2 sigma^2)).
    Returns (predicted (..., N) bool, confidence (..., N)).
    """
    d0 = sorted_distances[..., 0]
    tail = sorted_distances[..., 1:]
    sigma2 = torch.clamp(torch.mean(tail * tail, dim=-1) / 2.0, min=1e-20)
    confidence = torch.exp(-(d0 * d0) / (2.0 * sigma2))
    return confidence >= predictor_threshold, confidence


# ------------------------------------------------------------------- Gamma

def fit_gamma_mle(x, weights, newton_iters: int = 5):
    """Weighted Gamma MLE over the last axis (statx gammafit role):
    closed-form approximation of the shape from s = log(mean) -
    mean(log), refined with Newton on the profile likelihood; theta =
    mean / k. Returns (k, theta), each (...)."""
    w = weights
    n = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    xs = torch.clamp(x, min=1e-12)
    mean = torch.sum(w * xs, dim=-1) / n
    mean_log = torch.sum(w * torch.log(xs), dim=-1) / n
    s = torch.clamp(torch.log(mean) - mean_log, min=1e-8)
    k = (3.0 - s + torch.sqrt((s - 3.0) ** 2 + 24.0 * s)) / (12.0 * s)
    for _ in range(newton_iters):
        f = torch.log(k) - torch.special.digamma(k) - s
        fp = 1.0 / k - torch.special.polygamma(1, k)
        k_new = k - f / fp
        k = torch.where((k_new > 1e-6) & torch.isfinite(k_new), k_new, k)
    return k, mean / k


def gamma_logpdf(x, k, theta):
    xs = torch.clamp(x, min=1e-12)
    return ((k - 1.0) * torch.log(xs) - xs / theta -
            torch.special.gammaln(k) - k * torch.log(theta))


def gamma_cdf(x, k, theta):
    return torch.special.gammainc(k, torch.clamp(x, min=0.0) / theta)


# --------------------------------------------------------------------- GEV

def _xi_safe(xi):
    """A smooth Gumbel switch at tiny xi for numerical stability."""
    tiny = torch.where(xi < 0, torch.full_like(xi, -1e-6),
                       torch.full_like(xi, 1e-6))
    return torch.where(xi.abs() < 1e-6, tiny, xi)


def gev_logpdf(x, mu, sigma, xi):
    """statx gevpdf (gev.h:50-68) in log space; zero density (-inf)
    outside the support 1 + xi*(x-mu)/sigma > 0. The parameters
    broadcast against x."""
    sigma = torch.clamp(torch.as_tensor(sigma, dtype=x.dtype,
                                        device=x.device), min=1e-12)
    xi_safe = _xi_safe(torch.as_tensor(xi, dtype=x.dtype, device=x.device))
    t = 1.0 + xi_safe * ((x - mu) / sigma)
    valid = t > 1e-12
    ts = torch.clamp(t, min=1e-12)
    logp = (-(1.0 / xi_safe + 1.0) * torch.log(ts) -
            ts ** (-1.0 / xi_safe) - torch.log(sigma))
    return torch.where(valid, logp, torch.full_like(logp, -math.inf))


def gev_cdf(x, mu, sigma, xi):
    """statx gevcdf (gev.h:74-88); the parameters broadcast against x."""
    sigma = torch.clamp(torch.as_tensor(sigma, dtype=x.dtype,
                                        device=x.device), min=1e-12)
    xi_safe = _xi_safe(torch.as_tensor(xi, dtype=x.dtype, device=x.device))
    arg = 1.0 + xi_safe * ((x - mu) / sigma)
    cdf = torch.exp(-torch.clamp(arg, min=1e-12) ** (-1.0 / xi_safe))
    # outside the support: 0 below a lower bound (xi > 0), 1 above an
    # upper bound (xi < 0)
    outside = torch.where(xi_safe > 0, torch.zeros_like(cdf),
                          torch.ones_like(cdf))
    return torch.where(arg <= 0, outside, cdf)


def _gev_lmoments_init(x, weights):
    """Hosking's L-moment GEV estimator (closed form): robust init for
    the MLE refinement, over the last axis. Masked via rank computation
    over the valid entries only (invalid entries sort to +inf)."""
    xs = torch.sort(torch.where(weights > 0, x, torch.full_like(x, 1e30)),
                    dim=-1).values
    n = torch.clamp(torch.sum(weights > 0, dim=-1).to(x.dtype),
                    min=3.0)[..., None]
    j = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    xv = torch.where(j < n, xs, torch.zeros_like(xs))
    n = n[..., 0]
    b0 = torch.sum(xv, dim=-1) / n
    b1 = torch.sum(xv * j / torch.clamp(n - 1.0, min=1.0)[..., None],
                   dim=-1) / n
    b2 = torch.sum(xv * j * (j - 1.0) / torch.clamp(
        (n - 1.0) * (n - 2.0), min=1.0)[..., None], dim=-1) / n
    l1 = b0
    l2 = 2.0 * b1 - b0
    l3 = 6.0 * b2 - 6.0 * b1 + b0
    t3 = l3 / torch.where(l2.abs() < 1e-12, torch.full_like(l2, 1e-12), l2)
    c = 2.0 / (3.0 + t3) - math.log(2.0) / math.log(3.0)
    k_h = torch.clamp(7.8590 * c + 2.9554 * c * c, -0.99, 5.0)  # k = -xi
    g1k = torch.exp(torch.special.gammaln(1.0 + k_h))
    sigma = l2 * k_h / ((1.0 - 2.0 ** (-k_h)) * g1k)
    mu = l1 - sigma * (1.0 - g1k) / k_h
    return mu, torch.clamp(sigma, min=1e-9), -k_h


def _gev_nll(p, x, weights, n):
    """Weighted mean negative log-likelihood of one problem at p = (mu,
    log sigma, xi); outside-support samples add a large finite
    penalty."""
    lp = gev_logpdf(x, p[0], torch.exp(p[1]), p[2])
    lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -1e4))
    return -torch.sum(weights * lp) / n


def fit_gev_mle(x, weights, newton_iters: int = 8):
    """GEV MLE over the last axis (statx gevfit role): L-moment init +
    guarded Newton on the weighted negative log-likelihood over (mu,
    log sigma, xi). Steps that leave the support or increase the NLL
    are rejected. The gradient and Hessian of the 3-parameter NLL come
    from torch.func, one problem per vmap lane. Returns (mu, sigma,
    xi), each (...)."""
    mu0, sigma0, xi0 = _gev_lmoments_init(x, weights)
    batch = x.shape[:-1]
    xf = x.reshape((-1, x.shape[-1]))
    wf = weights.reshape(xf.shape)
    n = torch.clamp(torch.sum(wf, dim=-1), min=1.0)
    p = torch.stack([mu0, torch.log(sigma0), xi0], dim=-1).reshape((-1, 3))
    nll = torch.func.vmap(_gev_nll)
    grad = torch.func.vmap(torch.func.grad(_gev_nll))
    hess = torch.func.vmap(torch.func.hessian(_gev_nll))
    eye = 1e-6 * torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(newton_iters):
        g = grad(p, xf, wf, n)
        H = hess(p, xf, wf, n) + eye
        p_new = p - linalg.solve(H, g[..., None])[..., 0]
        better = (nll(p_new, xf, wf, n) < nll(p, xf, wf, n)) & \
            torch.isfinite(p_new).all(dim=-1)
        p = torch.where(better[:, None], p_new, p)
    p = p.reshape(batch + (3,))
    return p[..., 0], torch.exp(p[..., 1]), p[..., 2]


# ----------------------------------------------------------------- mixture

def evsac_mixture(sorted_distances, predictor_threshold=0.65,
                  row_mask=None):
    """Full EVSAC mixture calculation
    (ref EvsacSampler::CalculateMixtureModel, evsac_sampler.h:568-626).

    sorted_distances: (..., N, k) ascending k-NN match distances, k >= 3;
    row_mask (..., N). Returns (probabilities (..., N), sampling_weights
    (..., N), EvsacMixtureParams). Weights are posterior * predicted —
    queries the MR-Rayleigh predictor rejects are suppressed from
    sampling.
    """
    d = sorted_distances
    N = d.shape[-2]
    if row_mask is None:
        row_mask = torch.ones(d.shape[:-1], dtype=torch.bool,
                              device=d.device)
    predicted, _ = mr_rayleigh_predict(d, predictor_threshold)
    predicted = predicted & row_mask
    d1 = d[..., 0]
    w_pred = predicted.to(d.dtype)
    w_all = row_mask.to(d.dtype)
    inlier_ratio_ub = torch.sum(w_pred, dim=-1) / torch.clamp(
        torch.sum(w_all, dim=-1), min=1.0)

    # 2) Gamma on predicted-correct smallest distances
    gk, gtheta = fit_gamma_mle(d1, w_pred)
    # 3) reversed GEV on negated second-smallest distances
    mu, sigma, xi = fit_gev_mle(-d[..., 1], w_all)
    gk_, gth_, mu_, sg_, xi_ = (v[..., None] for v in
                                (gk, gtheta, mu, sigma, xi))

    # 4) inlier ratio: min_eps || y - eps*A1 - (1-eps)*A2 ||^2 over the
    # empirical CDF of the smallest distances, eps in [0, ub]
    xs = torch.sort(torch.where(row_mask, d1, torch.full_like(d1, 1e30)),
                    dim=-1).values
    n_valid = torch.clamp(torch.sum(w_all, dim=-1), min=2.0)[..., None]
    ranks = torch.arange(N, dtype=d.dtype, device=d.device)
    valid = ranks < n_valid
    y = (ranks + 1.0) / n_valid
    A1 = gamma_cdf(xs, gk_, gth_)
    A2 = 1.0 - gev_cdf(-xs, mu_, sg_, xi_)     # reversed-GEV CDF
    zero = torch.zeros_like(A1)
    num = torch.sum(torch.where(valid, (y - A2) * (A1 - A2), zero), dim=-1)
    den = torch.clamp(torch.sum(torch.where(valid, (A1 - A2) ** 2, zero),
                                dim=-1), min=1e-12)
    eps = torch.minimum(torch.clamp(num / den, min=0.0),
                        torch.clamp(inlier_ratio_ub, max=1.0))

    # 5) posterior + weights (ComputePosteriorAndWeights)
    e = eps[..., None]
    gam_val = e * torch.exp(gamma_logpdf(d1, gk_, gth_))
    gev_lp = gev_logpdf(-d1, mu_, sg_, xi_)
    gev_val = (1.0 - e) * torch.where(torch.isfinite(gev_lp),
                                      torch.exp(gev_lp), zero)
    posterior = gam_val / torch.clamp(gam_val + gev_val, min=1e-30)
    posterior = torch.where(row_mask, posterior, zero)
    weights = torch.where(predicted, posterior, zero)
    return posterior, weights, EvsacMixtureParams(gk, gtheta, mu, sigma,
                                                  xi, eps)


def _em_logpdf(x, mu, s):
    s = torch.clamp(s, min=1e-4)
    return -0.5 * ((x - mu) / s) ** 2 - torch.log(s)


def evsac_probabilities(distances, mask=None, iters: int = 30):
    """Lightweight fallback when only 1-NN distances are available (no
    (N, k) matrix for the full mixture): a two-component EM in
    log-distance space over the last axis of (..., N) distances.
    Prefer evsac_mixture for reference parity."""
    d = distances
    if mask is None:
        mask = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    x = torch.log(torch.clamp(d, min=1e-12))
    zero = torch.zeros_like(x)
    n = torch.clamp(torch.sum(mask, dim=-1).to(x.dtype), min=1.0)
    mean = torch.sum(torch.where(mask, x, zero), dim=-1) / n
    std = torch.sqrt(torch.clamp(torch.sum(torch.where(
        mask, (x - mean[..., None]) ** 2, zero), dim=-1) / n, min=1e-12))

    # init: inlier mode below the mean, outlier above
    mu1, s1 = mean - std, std * 0.5
    mu2, s2 = mean + 0.5 * std, std * 0.5
    pi = torch.full_like(mean, 0.3)
    for _ in range(iters):
        l1 = _em_logpdf(x, mu1[..., None], s1[..., None]) + \
            torch.log(torch.clamp(pi, min=1e-6))[..., None]
        l2 = _em_logpdf(x, mu2[..., None], s2[..., None]) + \
            torch.log(torch.clamp(1 - pi, min=1e-6))[..., None]
        r = torch.exp(l1 - torch.logaddexp(l1, l2))
        r = torch.where(mask, r, zero)
        r2 = torch.where(mask, 1.0 - r, zero)
        n1 = torch.clamp(torch.sum(r, dim=-1), min=1e-6)
        n2 = torch.clamp(torch.sum(r2, dim=-1), min=1e-6)
        mu1n = torch.sum(r * x, dim=-1) / n1
        mu2n = torch.sum(r2 * x, dim=-1) / n2
        s1n = torch.sqrt(torch.sum(r * (x - mu1n[..., None]) ** 2,
                                   dim=-1) / n1 + 1e-6)
        s2n = torch.sqrt(torch.sum(
            r2 * (x - mu2n[..., None]) ** 2, dim=-1) / n2 + 1e-6)
        # keep component 1 the small-distance one
        swap = mu1n > mu2n
        mu1, mu2 = torch.where(swap, mu2n, mu1n), torch.where(swap, mu1n,
                                                              mu2n)
        s1, s2 = torch.where(swap, s2n, s1n), torch.where(swap, s1n, s2n)
        pin = n1 / (n1 + n2)
        pi = torch.clamp(torch.where(swap, 1.0 - pin, pin), 0.01, 0.99)

    l1 = _em_logpdf(x, mu1[..., None], s1[..., None]) + \
        torch.log(pi)[..., None]
    l2 = _em_logpdf(x, mu2[..., None], s2[..., None]) + \
        torch.log(1 - pi)[..., None]
    post = torch.exp(l1 - torch.logaddexp(l1, l2))
    return torch.where(mask, post, zero)


def weighted_samples(generator, weights, sample_size, num_hypotheses):
    """Gumbel-top-k sampling proportional to (..., N) `weights` per
    hypothesis (the EVSAC sampler's role; ref evsac_sampler.h Sample +
    std::discrete_distribution), drawn on the generator's device:
    (..., H, sample_size) indices."""
    logw = torch.log(torch.clamp(weights, min=1e-12))
    g = _gumbel(generator, weights.shape[:-1] +
                (num_hypotheses, weights.shape[-1]), weights.dtype)
    return torch.topk(g + logw[..., None, :], sample_size, dim=-1).indices
