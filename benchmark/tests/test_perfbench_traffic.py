"""The traffic generator repeats exactly from a seed, and a seed moves the order of the work, never its amount."""

import numpy as np
import pytest
import torch

from benchmark.core import traffic
from benchmark.tests import tiny

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_open_arrivals_are_the_same_for_every_seed(seed):
    mix = {"arrivals": "exponential_quantiles", "rate_per_s": 9.5}
    a = traffic.open_arrivals(mix, seed, 30.0)
    assert len(a) == round(9.5 * 30) and a[0] == 0.0 and a[-1] < 30.0 and np.all(np.diff(a) > 0)
    assert np.array_equal(a, traffic.open_arrivals(mix, 1, 30.0))
    gaps = np.diff(np.append(a, 30.0))  # the last gap runs to the window's close
    quantiles = -np.log1p(-(np.arange(len(a)) + 0.5) / len(a))
    assert np.allclose(np.sort(gaps), np.sort(quantiles) * 30.0 / quantiles.sum())
    assert not np.array_equal(gaps, np.sort(gaps))  # shuffled, not sorted
    assert traffic.user_seeds(seed, 5) == traffic.user_seeds(seed, 5) != traffic.user_seeds(seed + 1, 5)
    assert all(0 <= s < 2**63 for s in traffic.user_seeds(seed, 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_inputs_repeat(seed):
    cfg, mix = tiny.config("cond-latent-512"), tiny.mix("gen-b16", batch=3)
    a = traffic.closed_inputs(cfg, mix, seed, 4, "cpu")
    b = traffic.closed_inputs(cfg, mix, seed, 4, "cpu")
    c = traffic.closed_inputs(cfg, mix, seed, 5, "cpu")
    assert set(a) == {"noise", "gl_phase", "encoding"}
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert a["noise"].shape == (3, *cfg["unet"]["sample_size"], 1)
    assert a["gl_phase"].shape == (3, cfg["mel"]["x_res"], cfg["mel"]["n_fft"] // 2 + 1)
    assert float(a["gl_phase"].min()) >= 0.0 and float(a["gl_phase"].max()) < 2 * np.pi
