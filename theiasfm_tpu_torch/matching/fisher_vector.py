"""Fisher-vector global image descriptors (GMM + FV encoding) and
global-descriptor-based image pair selection (port of
theiasfm_tpu/matching/fisher_vector.py).

ref: src/theia/matching/fisher_vector_extractor.{h,cc} (vlfeat GMM
training + Fisher encoding) and the kNN pair selection with query
expansion in src/theia/sfm/feature_extractor_and_matcher.cc:352-413.

GMM EM is dense batched responsibilities (softmax over components, one
(N, K) matmul-shaped op per step); FV encoding is a couple of
contractions; the all-pairs FV similarity is one product on the host.
Both run in float32 on the extractor's `device` (the card unless the
caller passes "cpu"). Where the JAX module draws the GMM's initial
means with jax.random.choice from PRNGKey(seed), this one draws them
from a CPU torch.Generator seeded with `seed`, or takes the initial
indices from the caller (`train(..., init_indices=...)`). The draw is on
the CPU whatever the device, as JAX's draw is the same on every
platform: a CUDA generator streams other rows than a CPU one, and the
card then chose other image pairs than the CPU from the same features
(24 views: 174 pairs against 171, 4 wide-baseline pairs only on the
card, whose models read 0.17-0.18 px against 0.11-0.13;
tests/frontend24_probe.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from ..utils.device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class FisherVectorOptions:
    """ref: FisherVectorExtractor::Options."""
    num_gmm_clusters: int = 16
    max_num_features_for_training: int = 100_000
    em_iterations: int = 20


def _log_prob(X, means, var, w):
    """(N, K) log N(x; mu_k, var_k) + log w_k, up to a constant."""
    diff = X[:, None, :] - means[None, :, :]
    ll = -0.5 * torch.sum(diff * diff / var[None], dim=-1)
    ll = ll - 0.5 * torch.sum(torch.log(var), dim=-1)[None, :]
    return ll + torch.log(torch.clamp(w, min=1e-12))[None, :], diff


def _train_gmm(X, init_idx, iters: int):
    """Diagonal-covariance GMM via EM. X (N, D), init_idx (K,) rows of X
    for the initial means. Returns (means (K, D), variances (K, D),
    weights (K,))."""
    N, D = X.shape
    K = init_idx.shape[0]
    means = X[init_idx]
    var = torch.var(X, dim=0, unbiased=False)[None, :].repeat(K, 1) + 1e-4
    w = torch.full((K,), 1.0 / K, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        lp, _ = _log_prob(X, means, var, w)
        r = torch.softmax(lp, dim=-1)                 # (N, K)
        nk = torch.sum(r, dim=0) + 1e-10
        means = (r.T @ X) / nk[:, None]
        ex2 = (r.T @ (X * X)) / nk[:, None]
        var = torch.clamp(ex2 - means * means, min=1e-4)
        w = nk / N
    return means, var, w


def _fisher_encode(X, mask, means, var, w):
    """Improved Fisher vector of one image's descriptors.

    X (N, D), mask (N,). Returns (2*K*D,) power+L2-normalized.
    """
    ll, diff = _log_prob(X, means, var, w)
    r = torch.softmax(ll, dim=-1) * mask[:, None]         # (N, K)
    n = torch.clamp(torch.sum(mask), min=1.0)
    sigma = torch.sqrt(var)
    u = diff / sigma[None]                                # (N, K, D)
    sw = torch.clamp(w, min=1e-12)
    g_mu = torch.einsum("nk,nkd->kd", r, u) / \
        (n * torch.sqrt(sw)[:, None])
    g_sig = torch.einsum("nk,nkd->kd", r, u * u - 1.0) / \
        (n * torch.sqrt(2.0 * sw)[:, None])
    fv = torch.cat([g_mu.reshape(-1), g_sig.reshape(-1)])
    fv = torch.sign(fv) * torch.sqrt(torch.abs(fv))      # power norm
    return fv / torch.clamp(torch.linalg.norm(fv), min=1e-12)


class FisherVectorExtractor:
    """ref: FisherVectorExtractor (train on pooled descriptors, then
    encode per image), on `device`."""

    def __init__(self, options: FisherVectorOptions =
                 FisherVectorOptions(), seed: int = 0, device="cuda"):
        self.options = options
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(seed)
        self.gmm = None

    def initial_indices(self, n: int) -> torch.Tensor:
        """The GMM's initial rows: K distinct rows of n, drawn without
        replacement from the CPU generator (the same on every device)."""
        return torch.randperm(n, generator=self.generator)[
            :self.options.num_gmm_clusters]

    @full_f32()
    def train(self, descriptors: np.ndarray, init_indices=None):
        """Fit the GMM. init_indices: optional (K,) rows of the
        (subsampled) training set for the initial means; drawn without
        replacement from the CPU generator by default."""
        X = np.asarray(descriptors, np.float32)
        cap = self.options.max_num_features_for_training
        if X.shape[0] > cap:
            sel = np.random.default_rng(0).choice(X.shape[0], cap,
                                                  replace=False)
            X = X[sel]
        X = torch.as_tensor(X, device=self.device)
        if init_indices is None:
            init = self.initial_indices(X.shape[0]).to(self.device)
        else:
            init = torch.as_tensor(np.asarray(init_indices),
                                   device=self.device).long()
        with torch.no_grad():
            self.gmm = _train_gmm(X, init, self.options.em_iterations)

    @full_f32()
    def extract_global_descriptor(self, descriptors: np.ndarray,
                                  mask=None) -> np.ndarray:
        assert self.gmm is not None, "call train() first"
        X = torch.as_tensor(np.asarray(descriptors, np.float32),
                            device=self.device)
        m = (torch.ones(X.shape[0], device=self.device) if mask is None
             else torch.as_tensor(np.asarray(mask, np.float32),
                                  device=self.device))
        with torch.no_grad():
            return _fisher_encode(X, m, *self.gmm).cpu().numpy()


def select_image_pairs_from_global_descriptors(
        global_descriptors: Dict[str, np.ndarray],
        num_nearest_neighbors: int = 20,
        use_query_expansion: bool = True) -> List[Tuple[str, str]]:
    """kNN candidate pairs over FV similarity + one round of query
    expansion (ref feature_extractor_and_matcher.cc:352-413). Host
    numpy, as in the JAX module."""
    names = sorted(global_descriptors.keys())
    if len(names) < 2:
        return []
    F = np.stack([global_descriptors[n] for n in names])
    sim = F @ F.T
    np.fill_diagonal(sim, -np.inf)
    k = min(num_nearest_neighbors, len(names) - 1)
    pairs: Set[Tuple[str, str]] = set()
    knn = np.argsort(-sim, axis=1)[:, :k]
    for i in range(len(names)):
        for j in knn[i]:
            a, b = names[i], names[int(j)]
            pairs.add((a, b) if a < b else (b, a))
    if use_query_expansion:
        # neighbors-of-neighbors (one hop)
        adj: Dict[int, Set[int]] = {i: set() for i in range(len(names))}
        name_idx = {n: i for i, n in enumerate(names)}
        for (a, b) in pairs:
            adj[name_idx[a]].add(name_idx[b])
            adj[name_idx[b]].add(name_idx[a])
        for i in range(len(names)):
            for j in list(adj[i]):
                for l in adj[j]:
                    if l != i:
                        a, b = names[i], names[l]
                        pairs.add((a, b) if a < b else (b, a))
    return sorted(pairs)
