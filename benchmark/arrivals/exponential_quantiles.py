"""Poisson-like arrivals at ``rate_per_s`` with the same due times for every seed.

``round(rate_per_s * seconds)`` arrivals: the exponential distribution's n
quantiles at the mix's rate, scaled to sum to the window, in one fixed
shuffled order. The seed moves which user's request comes when, never the
arrival pattern: with the order drawn from the seed, the tail of an open loop
moved with the order of its gaps far more than between two runs of one seed
(PERF.md, section 6).
"""

import numpy as np

from benchmark.core.weights import derive_seed

ORDER_TAG = 101


def due(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, the first at 0 and all inside [0, seconds):
    the last gap runs from the last arrival to the window's close."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / mix["rate_per_s"]
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(derive_seed(0, ORDER_TAG)).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
