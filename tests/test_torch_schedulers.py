"""Port parity of the schedulers: DDPM ``step``/``add_noise``, DDIM ``eta > 0``
and ``invert_step`` against the JAX package with the JAX draw injected (atol
1e-6); per-row step noise; and the scheduler config read and written across
packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch import schedulers as tsch
from audio_diffusion_torch.schedulers import common
from audio_diffusion_torch.schedulers.common import step_noises, variance_noise
from audio_diffusion_tpu import schedulers as jsch

ATOL = 1e-6


def _inputs(seed=20):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 1)).astype(np.float32) * 2 for _ in range(2))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_ddpm_step_matches_jax(prediction_type):
    x, eps = _inputs()
    cfg = dict(prediction_type=prediction_type)
    jsched, tsched = jsch.DDPMScheduler(jsch.SchedulerConfig(**cfg)), tsch.DDPMScheduler(tsch.SchedulerConfig(**cfg))
    np.testing.assert_array_equal(tsched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))
    assert tsched.default_num_inference_steps() == jsched.default_num_inference_steps() == 1000
    for steps in (1000, 50):
        schedule = jsched.schedule(steps)
        for t in (int(schedule.timesteps[0]), 500, int(schedule.timesteps[-1])):
            key = jax.random.key(t)
            want = np.asarray(jsched.step(jnp.asarray(eps), t, jnp.asarray(x), schedule, key=key))
            noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))
            got = tsched.step(torch.from_numpy(eps), t, torch.from_numpy(x), tsched.schedule(steps), noise=noise)
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(tsched.add_noise(torch.from_numpy(x), torch.from_numpy(eps), 300).numpy(),
                               np.asarray(jsched.add_noise(jnp.asarray(x), jnp.asarray(eps), 300)), atol=ATOL)


@pytest.mark.parametrize("eta", [0.3, 1.0])
def test_ddim_stochastic_step_and_inversion_match_jax(eta):
    x, eps = _inputs(21)
    jsched, tsched = jsch.DDIMScheduler(), tsch.DDIMScheduler()
    schedule, tschedule = jsched.schedule(50), tsched.schedule(50)
    for t in (980, 400, 0):
        key = jax.random.key(t + 1)
        want = np.asarray(jsched.step(jnp.asarray(eps), t, jnp.asarray(x), schedule, eta=eta, key=key))
        noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))
        got = tsched.step(torch.from_numpy(eps), t, torch.from_numpy(x), tschedule, eta=eta, noise=noise)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        want = np.asarray(jsched.invert_step(jnp.asarray(eps), t, jnp.asarray(x), schedule))
        got = tsched.invert_step(torch.from_numpy(eps), t, torch.from_numpy(x), tschedule)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_per_row_step_noise_is_independent_of_the_co_batch():
    shape = (3, 4, 4, 1)

    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]

    alone = list(step_noises((1, *shape[1:]), 5, torch.device("cpu"), gens([7])))
    batched = list(step_noises(shape, 5, torch.device("cpu"), gens([3, 7, 11])))
    other = list(step_noises(shape, 5, torch.device("cpu"), gens([9, 7, 5])))
    for a, b, o in zip(alone, batched, other):
        assert torch.equal(a[0], b[1]) and torch.equal(b[1], o[1])
        assert not torch.equal(b[0], b[1])
    assert not torch.equal(alone[0], alone[1]), "each step draws anew"
    # Above the chain budget a row draws step by step; still per row.
    big = (2, 64, 64, 1)
    steps = common.ROW_CHAIN_BYTES // (64 * 64 * 4) + 1
    rows = [next(step_noises(big, steps, torch.device("cpu"), gens(s))) for s in ([1, 2], [1, 3])]
    assert torch.equal(rows[0][0], rows[1][0]) and not torch.equal(rows[0][1], rows[1][1])
    # One shared generator: one batch-shaped draw per step (the reference's chain).
    shared = variance_noise(torch.zeros(shape), torch.Generator().manual_seed(7))
    assert torch.equal(shared, torch.randn(shape, generator=torch.Generator().manual_seed(7)))
    with pytest.raises(ValueError, match="per-row generators"):
        next(step_noises(shape, 2, torch.device("cpu"), gens([1, 2])))
    with pytest.raises(ValueError, match="step_noise must be"):
        next(step_noises(shape, 2, torch.device("cpu"), noise=torch.zeros(1, *shape)))


@pytest.mark.parametrize("cls", ["DDIMScheduler", "DDPMScheduler"])
def test_scheduler_config_round_trips_across_packages(cls, tmp_path):
    cfg = dict(num_train_timesteps=500, beta_schedule="scaled_linear", prediction_type="v_prediction",
               steps_offset=1)
    jsched = getattr(jsch, cls)(jsch.SchedulerConfig(**cfg))
    tsched = getattr(tsch, cls)(tsch.SchedulerConfig(**cfg))
    jsch.save_scheduler(jsched, str(tmp_path / "jax"))
    tsch.save_scheduler(tsched, str(tmp_path / "torch"))
    from_jax = tsch.load_scheduler(str(tmp_path / "jax"))
    from_torch = jsch.load_scheduler(str(tmp_path / "torch"))
    assert type(from_jax).__name__ == type(from_torch).__name__ == cls
    assert (dataclasses.asdict(from_jax.config) == dataclasses.asdict(from_torch.config)
            == dataclasses.asdict(tsch.SchedulerConfig(**cfg)))
    np.testing.assert_array_equal(from_jax.alphas_cumprod, np.asarray(from_torch.alphas_cumprod))
    np.testing.assert_array_equal(from_jax.schedule(20).timesteps, from_torch.schedule(20).timesteps)
    assert type(tsch.scheduler_from_config({"_class_name": "DDIMScheduler"})).__name__ == "DDIMScheduler"
    assert type(tsch.scheduler_from_config({})).__name__ == "DDPMScheduler"
