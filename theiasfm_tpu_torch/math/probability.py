"""Statistical utilities (a copy of theiasfm_tpu/math/probability.py,
which needs only numpy).

ref: src/theia/math/probability/sequential_probability_ratio.{h,cc}
(SPRT for RANSAC model pre-verification), src/theia/math/distribution.h
(normal/uniform), src/theia/math/histogram.h, reservoir sampling
(src/theia/math/reservoir_sampler.h).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def sprt_decision_threshold(sigma: float, epsilon: float,
                            t_m: float = 200.0, m_s: float = 1.0) -> float:
    """Optimal SPRT decision threshold A* (ref
    sequential_probability_ratio.cc CalculateSPRTDecisionThreshold):
    sigma = P(good datum | bad model), epsilon = inlier ratio,
    t_m = relative model evaluation cost, m_s = models per sample."""
    c = (1.0 - sigma) * math.log((1.0 - sigma) / (1.0 - epsilon)) + \
        sigma * math.log(sigma / epsilon)
    a_0 = t_m * c / m_s + 1.0
    a = a_0
    for _ in range(10):
        a = a_0 + math.log(a)
    return a


def sequential_probability_ratio_test(residuals, error_thresh: float,
                                      sigma: float, epsilon: float,
                                      decision_threshold: float):
    """Evaluate datums sequentially; returns (accepted, num_tested,
    observed inlier ratio). ref SequentialProbabilityRatioTest."""
    lam = 1.0
    n = 0
    n_inl = 0
    for r in np.asarray(residuals):
        n += 1
        if r < error_thresh:
            n_inl += 1
            lam *= sigma / epsilon
        else:
            lam *= (1.0 - sigma) / (1.0 - epsilon)
        if lam > decision_threshold:
            return False, n, n_inl / n
    return True, n, n_inl / max(n, 1)


class NormalDistribution:
    """ref: math/distribution.h."""

    def __init__(self, mean: float, sigma: float):
        self.mean = mean
        self.sigma = sigma

    def eval(self, x):
        z = (np.asarray(x) - self.mean) / self.sigma
        return np.exp(-0.5 * z * z) / (self.sigma * np.sqrt(2 * np.pi))


class UniformDistribution:
    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = lo, hi

    def eval(self, x):
        x = np.asarray(x)
        return np.where((x >= self.lo) & (x <= self.hi),
                        1.0 / (self.hi - self.lo), 0.0)


class Histogram:
    """ref: math/histogram.h — fixed boundaries, counts above end."""

    def __init__(self, boundaries: List[float]):
        self.boundaries = list(boundaries)
        self.counts = np.zeros(len(boundaries), dtype=np.int64)

    def add(self, value: float):
        idx = np.searchsorted(self.boundaries, value, side="right")
        if idx >= len(self.counts):
            idx = len(self.counts) - 1
        self.counts[idx] += 1


class ReservoirSampler:
    """ref: math/reservoir_sampler.h — uniform sample of a stream."""

    def __init__(self, k: int, seed: int = 0):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.samples: list = []
        self.n_seen = 0

    def add(self, item):
        self.n_seen += 1
        if len(self.samples) < self.k:
            self.samples.append(item)
        else:
            j = self.rng.integers(0, self.n_seen)
            if j < self.k:
                self.samples[j] = item
