"""Shared diffusion-schedule math (port of ``audio_diffusion_tpu/schedulers/common.py``).

Numeric semantics match diffusers 0.24: linear betas 1e-4 -> 2e-2, "leading"
timestep spacing, epsilon prediction, ``clip_sample=True``. Tables are numpy;
per-step scalars are f32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import ConfigMixin


def variance_noise(sample: torch.Tensor, generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-step sampling noise for stochastic steps (DDIM eta > 0): ``noise``
    when injected (how tests hand both packages one draw), else a standard
    normal draw like ``sample`` from ``generator``. torch cannot reproduce
    ``jax.random``, so only injected noise matches the JAX package."""
    if noise is not None:
        return noise.to(device=sample.device, dtype=sample.dtype)
    device = generator.device if generator is not None else sample.device
    return torch.randn(sample.shape, generator=generator, device=device, dtype=sample.dtype).to(sample.device)


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float, beta_schedule: str) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        i = np.arange(num_train_timesteps, dtype=np.float64)
        return np.minimum(1 - alpha_bar((i + 1) / num_train_timesteps) / alpha_bar(i / num_train_timesteps), 0.999)
    raise ValueError(f"Unknown beta_schedule {beta_schedule!r}")


class Schedule(NamedTuple):
    """A concrete inference schedule: descending ``timesteps`` (numpy) and
    ``step_delta = num_train // num_inference``, which finds the previous timestep."""

    timesteps: np.ndarray
    num_inference_steps: int
    step_delta: int


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int, steps_offset: int = 0) -> Schedule:
    """diffusers "leading" spacing: ``(arange(n) * (T // n)).round()[::-1] + offset``."""
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64) + steps_offset
    return Schedule(timesteps, num_inference_steps, step_ratio)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig(ConfigMixin):
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    prediction_type: str = "epsilon"
    steps_offset: int = 0

    config_name = "scheduler_config.json"


def predict_x0_and_eps(sample: torch.Tensor, model_output: torch.Tensor, alpha_prod_t: np.float32,
                       prediction_type: str):
    """Recover (x0_hat, eps_hat) from the model output under a prediction
    type; ``alpha_prod_t`` is an f32 scalar."""
    alpha_prod_t = np.float32(alpha_prod_t)
    sqrt_a = float(np.sqrt(alpha_prod_t))
    sqrt_b = float(np.sqrt(np.float32(1.0) - alpha_prod_t))
    if prediction_type == "epsilon":
        x0 = (sample - sqrt_b * model_output) / sqrt_a
        eps = model_output
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / sqrt_b
    elif prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_b * model_output
        eps = sqrt_a * model_output + sqrt_b * sample
    else:
        raise ValueError(f"Unknown prediction_type {prediction_type!r}")
    return x0, eps
