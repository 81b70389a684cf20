"""Batched hypothesize-and-verify robust estimation, the RANSAC engine
(port of theiasfm_tpu/solvers/ransac.py).

ref: src/theia/solvers/estimator.h:54-95,
sample_consensus_estimator.h:57-136 and the RANSAC/PROSAC/LMed/
Exhaustive variants. All hypotheses are generated and scored in one
fixed-shape batched computation: sample H minimal subsets, solve them
all at once, score every (model, datum) pair, take the first best
score. The adaptive-termination bound is reported as the confidence
the static budget achieved (RansacSummary mirrors ref RansacSummary).

The engine (`ransac_batch`) runs B problems at once along a leading
axis; `ransac` is one problem. Both take, where the JAX module takes a
PRNG key, either a torch.Generator, from which they draw the sample
indices on the generator's device, or precomputed indices: no torch
generator reproduces JAX's stream, so the tests hand both packages the
same indices.

Quality measures: 'inlier', 'msac', 'mle', 'lmed' (ref
quality_measurement.h variants). Samplers: 'random' (Gumbel top-k,
exact sampling without replacement within a hypothesis), 'prosac',
'exhaustive' and 'weighted' (EVSAC, Gumbel top-k on the log weights of
`sample_weights`, solvers/evsac.py; 'random' with weights given does
the same).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """ref RansacParameters (sample_consensus_estimator.h:57-130); the
    max_iterations/min_iterations pair becomes `num_hypotheses`."""
    error_thresh: float  # threshold on the *squared* residual, like ref
    num_hypotheses: int = 512
    quality: str = "inlier"          # 'inlier'|'msac'|'mle'|'lmed'
    sampler: str = "random"  # 'random'|'prosac'|'exhaustive'|'weighted'
    failure_probability: float = 0.01
    model_chunk: int = 128           # score this many models at a time


class RansacSummary(NamedTuple):
    """ref RansacSummary (sample_consensus_estimator.h:132+); batched
    fields lead with the problem axis in `ransac_batch`."""
    inliers: torch.Tensor         # (N,) bool mask
    num_inliers: torch.Tensor     # scalar int
    num_hypotheses: int
    confidence: torch.Tensor      # 1 - (1 - w^s)^H achieved by the budget
    best_score: torch.Tensor      # engine-internal score of the winner


@dataclasses.dataclass(frozen=True)
class MinimalSolverSpec:
    """A minimal solver adapted to the batched engine.

    solve: dict of (..., sample_size, k) tensors
           -> (models (..., max_models, *model), valid (..., max_models))
    residuals: (models (B, C, *model), data dict of (B, N, k))
               -> (B, C, N) squared errors
    refine: optional (model (B, *model), data, weights (B, N))
            -> model (B, *model), a weighted nonminimal re-estimation
            on the inliers (ref Estimator::RefineModel).
    A degenerate sample is reported by `solve` as valid=False.
    """
    name: str
    sample_size: int
    max_models: int
    solve: Callable[[Any], tuple]
    residuals: Callable[[Any, Any], torch.Tensor]
    refine: Optional[Callable[[Any, Any, torch.Tensor], Any]] = None


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def _gumbel(generator, shape, dtype=torch.float32):
    e = torch.empty(shape, dtype=dtype, device=generator.device)
    return -torch.log(e.exponential_(generator=generator))


def _top_k_samples(g, sample_size, valid_mask=None, in_pool=None):
    """The indices of the sample_size largest of (..., H, N) scores g,
    after masking (..., N) invalid data and (H, N) out-of-pool data."""
    if in_pool is not None:
        g = g.masked_fill(~in_pool, -math.inf)
    if valid_mask is not None:
        g = g.masked_fill(~valid_mask[..., None, :], -math.inf)
    return torch.topk(g, sample_size, dim=-1).indices


def random_samples(generator, num_data, sample_size, num_hypotheses,
                   valid_mask=None):
    """(..., H, s) index samples without replacement within a
    hypothesis (Gumbel top-k over per-hypothesis random scores), drawn
    on the generator's device; leading dims from `valid_mask`
    (..., N)."""
    batch = () if valid_mask is None else tuple(valid_mask.shape[:-1])
    g = _gumbel(generator, batch + (num_hypotheses, num_data))
    return _top_k_samples(g, sample_size, valid_mask)


def _prosac_pool(num_data, sample_size, num_hypotheses, device):
    """(H, N) mask of hypothesis h's pool: the top n_h data, n_h growing
    linearly from sample_size+1 to num_data across the budget."""
    h = torch.arange(num_hypotheses, device=device)
    pool = sample_size + 1 + (
        (num_data - sample_size - 1) * h // max(num_hypotheses - 1, 1))
    return torch.arange(num_data, device=device)[None, :] < pool[:, None]


def prosac_samples(generator, num_data, sample_size, num_hypotheses,
                   valid_mask=None):
    """PROSAC-style progressive sampling (ref prosac_sampler.h): data is
    assumed sorted by quality; hypothesis h draws from the top-n_h
    pool."""
    batch = () if valid_mask is None else tuple(valid_mask.shape[:-1])
    g = _gumbel(generator, batch + (num_hypotheses, num_data))
    return _top_k_samples(g, sample_size, valid_mask, _prosac_pool(
        num_data, sample_size, num_hypotheses, generator.device))


def exhaustive_pair_samples(num_data, num_hypotheses, device="cuda"):
    """All (i, j) pairs, row-major, truncated/repeated to the budget
    (ref exhaustive_sampler.h supports sample_size 2), on `device` (the
    card unless the caller passes "cpu")."""
    idx = torch.triu_indices(num_data, num_data, offset=1,
                             device=resolve_device(device)).T
    reps = -(-num_hypotheses // idx.shape[0])
    return idx.repeat(reps, 1)[:num_hypotheses]


def draw_samples(generator, spec: MinimalSolverSpec, num_data,
                 options: RansacOptions, data_mask=None, sort_order=None,
                 sample_weights=None):
    """The sampler of `options` on the generator's device: (..., H, s)
    indices, leading dims from `data_mask`."""
    H = options.num_hypotheses
    s = spec.sample_size
    if options.sampler == "weighted" or (options.sampler == "random" and
                                         sample_weights is not None):
        # EVSAC-style probability-proportional sampling
        # (ref evsac_sampler.h; weights from solvers/evsac.py)
        from .evsac import weighted_samples
        if sample_weights is None:
            raise ValueError("sampler='weighted' draws by sample_weights "
                             "(EVSAC's, solvers/evsac.py); none given")
        w = sample_weights
        if data_mask is not None:
            w = w * data_mask
        return weighted_samples(generator, w, s, H)
    if options.sampler == "random":
        return random_samples(generator, num_data, s, H, data_mask)
    if options.sampler == "prosac":
        idx = prosac_samples(generator, num_data, s, H, data_mask)
        if sort_order is not None:
            # sampled in sorted space; map back
            idx = torch.gather(
                sort_order, -1, idx.flatten(-2)).reshape(idx.shape)
        return idx
    if options.sampler == "exhaustive":
        idx = exhaustive_pair_samples(num_data, H, generator.device)
        if data_mask is not None:
            idx = idx.expand(tuple(data_mask.shape[:-1]) + idx.shape)
        return idx
    raise ValueError(options.sampler)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _score_chunk(r, data_mask, options: RansacOptions):
    """(B, C, N) squared residuals -> (scores, inlier counts) (B, C);
    higher scores are better in every mode (lmed negated)."""
    thresh = options.error_thresh
    if data_mask is not None:
        r = r.masked_fill(~data_mask[:, None, :], math.inf)
    inl = r < thresh
    n_inl = inl.sum(dim=-1)
    q = options.quality
    if q == "inlier":
        score = n_inl.to(r.dtype)
    elif q == "msac":
        score = -torch.clamp(r, max=thresh).sum(dim=-1)
    elif q == "mle":
        # ref MLEQualityMeasurement: the truncated Gaussian likelihood
        # exp(-r / (2 sigma^2)) with sigma tied to the threshold, summed
        # in log space
        sigma2 = (thresh / 3.0) ** 2
        lik = torch.exp(-torch.clamp(r, max=thresh) / (2.0 * sigma2))
        score = torch.log(lik + 1e-12).sum(dim=-1)
    elif q == "lmed":
        sort_r = torch.sort(r, dim=-1).values
        if data_mask is not None:
            # median over valid data: the k-th smallest, k = n_valid // 2
            k = torch.clamp(data_mask.sum(dim=-1) // 2, min=1)
            idx = (k - 1)[:, None, None].expand(r.shape[0], r.shape[1], 1)
            score = -torch.gather(sort_r, -1, idx)[..., 0]
        else:
            n = r.shape[-1]
            med = sort_r[..., n // 2] if n % 2 else \
                0.5 * (sort_r[..., n // 2 - 1] + sort_r[..., n // 2])
            score = -med
    else:
        raise ValueError(q)
    return score, n_inl


def _score_models(residual_fn, models, models_valid, data, data_mask,
                  options: RansacOptions):
    """Score (B, M) models in chunks of options.model_chunk models; the
    chunking bounds the (B, C, N) residual temporaries and leaves the
    result unchanged."""
    M = models.shape[1]
    C = min(options.model_chunk, M)
    if not (M % C == 0 and M > C):
        C = M
    scores, counts = [], []
    for c0 in range(0, M, C):
        r = residual_fn(models[:, c0:c0 + C], data)
        s, n = _score_chunk(r, data_mask, options)
        scores.append(s)
        counts.append(n)
    score = torch.cat(scores, dim=1)
    n_inl = torch.cat(counts, dim=1)
    score = score.masked_fill(~models_valid, -math.inf)
    return score, n_inl


def _gather_rows(x, idx):
    """x (B, N, ...), idx (B, ...) int -> x[b, idx[b]] (B, ..., ...)."""
    B = x.shape[0]
    b = torch.arange(B, device=x.device).reshape((B,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def ransac_batch(samples, spec: MinimalSolverSpec, data,
                 options: RansacOptions, data_mask=None, num_data=None,
                 sort_order=None, sample_weights=None):
    """Run B RANSAC problems at once.

    Args:
      samples: a torch.Generator (indices drawn on its device by
        options.sampler) or precomputed (B, H, s) indices.
      spec: the minimal solver adapter.
      data: dict of (B, N, ...) tensors.
      options: RansacOptions.
      data_mask: optional (B, N) bool, False on padded/invalid data.
      num_data: optional override of N for the confidence, scalar or
        (B,).
      sort_order: optional (B, N) permutation by quality for PROSAC.
      sample_weights: optional (B, N) sampling weights for the
        'weighted' sampler (EVSAC).
    Returns:
      (best_model (B, ...), RansacSummary with leading B). The model is
      refined on its inliers when spec.refine is given.
    """
    first = next(iter(data.values()))
    B, N = first.shape[:2]
    H = options.num_hypotheses
    if isinstance(samples, torch.Generator):
        # one draw per problem, masked or not
        mask = data_mask if data_mask is not None else torch.ones(
            (B, N), dtype=torch.bool, device=samples.device)
        idx = draw_samples(samples, spec, N, options, mask, sort_order,
                           sample_weights)
    else:
        idx = samples.to(first.device)
    if tuple(idx.shape) != (B, H, spec.sample_size):
        raise ValueError(f"samples of shape {tuple(idx.shape)}, expected "
                         f"{(B, H, spec.sample_size)}")

    subsets = {k: _gather_rows(v, idx) for k, v in data.items()}
    models, valid = spec.solve(subsets)          # (B, H, M, ...)
    models = models.flatten(1, 2)
    valid = valid.flatten(1, 2)

    score, _ = _score_models(spec.residuals, models, valid, data,
                             data_mask, options)
    # the first best, as jnp.argmax (integer scores tie often)
    best = torch.argmax(score, dim=1)
    best_model = _gather_rows(models, best)
    best_score = torch.gather(score, 1, best[:, None])[:, 0]

    def inliers_of(model):
        inl = spec.residuals(model[:, None], data)[:, 0] < \
            options.error_thresh
        return inl if data_mask is None else inl & data_mask

    inliers = inliers_of(best_model)
    num_inliers = inliers.sum(dim=-1)

    if spec.refine is not None:
        refined = spec.refine(best_model, data, inliers.to(first.dtype))
        # keep the refinement only if it does not lose inliers
        inl_ref = inliers_of(refined)
        better = inl_ref.sum(dim=-1) >= num_inliers
        best_model = torch.where(
            better.reshape((B,) + (1,) * (refined.dim() - 1)), refined,
            best_model)
        inliers = torch.where(better[:, None], inl_ref, inliers)
        num_inliers = inliers.sum(dim=-1)

    if num_data is not None:
        n_total = torch.as_tensor(num_data, device=first.device)
    elif data_mask is not None:
        n_total = data_mask.sum(dim=-1)
    else:
        n_total = torch.full((B,), N, device=first.device)
    w_ratio = num_inliers.to(first.dtype) / torch.clamp(n_total, min=1)
    # P(all H samples contaminated): the budget's achieved confidence
    log_fail = H * torch.log1p(-torch.clamp(
        w_ratio ** spec.sample_size, max=1 - 1e-12))
    confidence = 1.0 - torch.exp(log_fail)

    return best_model, RansacSummary(
        inliers=inliers, num_inliers=num_inliers, num_hypotheses=H,
        confidence=confidence, best_score=best_score)


def ransac(samples, spec: MinimalSolverSpec, data, options: RansacOptions,
           data_mask=None, num_data=None, sort_order=None,
           sample_weights=None):
    """One RANSAC problem: data a dict of (N, ...) tensors, samples a
    torch.Generator or (H, s) indices. Returns (best_model,
    RansacSummary); see ransac_batch."""
    def one(x):
        return None if x is None else torch.as_tensor(x)[None]
    if not isinstance(samples, torch.Generator):
        samples = samples[None]
    model, s = ransac_batch(
        samples, spec, {k: v[None] for k, v in data.items()}, options,
        one(data_mask), one(num_data), one(sort_order), one(sample_weights))
    return model[0], RansacSummary(
        inliers=s.inliers[0], num_inliers=s.num_inliers[0],
        num_hypotheses=s.num_hypotheses, confidence=s.confidence[0],
        best_score=s.best_score[0])


def ransac_adaptive(generator, spec: MinimalSolverSpec, data,
                    options: RansacOptions, data_mask=None,
                    num_data=None, sort_order=None, sample_weights=None,
                    min_hypotheses: int = 32):
    """Bucketed adaptive termination around the one-shot engine.

    The reference's sequential loop stops once k >= log(delta) /
    log(1 - w^s) for the current inlier ratio w (ref
    sample_consensus_estimator.h:148+). The same compute profile comes
    from hypothesis buckets growing 4x (H = 32, 128, 512, ...), each
    drawn from `generator`, stopping once the cumulative budget meets
    the bound for the best model so far.

    Returns (best_model, RansacSummary) with num_hypotheses the budget
    spent and confidence the cumulative 1 - (1 - w^s)^H_total.
    """
    H_max = options.num_hypotheses
    H = min(min_hypotheses, H_max)
    delta = options.failure_probability
    first = next(iter(data.values()))
    best_model, best_summary = None, None
    total_H = 0
    while True:
        opts_b = dataclasses.replace(options, num_hypotheses=H)
        model, summary = ransac(generator, spec, data, opts_b,
                                data_mask=data_mask, num_data=num_data,
                                sort_order=sort_order,
                                sample_weights=sample_weights)
        total_H += H
        if (best_summary is None or
                int(summary.num_inliers) > int(best_summary.num_inliers)):
            best_model, best_summary = model, summary
        n_tot = (num_data if num_data is not None else
                 int(data_mask.sum()) if data_mask is not None else
                 first.shape[0])
        w = float(best_summary.num_inliers) / max(int(n_tot), 1)
        ws = min(w ** spec.sample_size, 1.0 - 1e-12)
        conf = 1.0 - math.exp(total_H * math.log1p(-ws))
        if conf >= 1.0 - delta or total_H >= H_max:
            break
        H = min(H * 4, H_max - total_H)
    summary = best_summary._replace(
        num_hypotheses=total_H,
        confidence=torch.tensor(conf, dtype=torch.float32))
    return best_model, summary


def hypotheses_for_confidence(sample_size: int, inlier_ratio: float,
                              failure_probability: float = 0.01) -> int:
    """Hypothesis budget H with P(no all-inlier sample) <
    failure_probability: the bound the reference adapts its loop by,
    used here to size the batch up front."""
    w = inlier_ratio ** sample_size
    if w >= 1.0:
        return 1
    return max(1, int(math.ceil(math.log(failure_probability) /
                                math.log(1.0 - w))))
