"""DDPM (ancestral) scheduler (port of ``audio_diffusion_tpu/schedulers/ddpm.py``).

diffusers 0.24 semantics with ``variance_type="fixed_small"``.
``alphas_cumprod`` comes from numpy float64 cast to f32 and every per-step
coefficient is f32 arithmetic on the host, as in :mod:`.ddim`, so a step is a
few elementwise ops on the device with the constants the JAX program computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import (Schedule, SchedulerConfig, StepGenerator, add_noise, leading_timesteps, make_betas,
                     predict_x0_and_eps, variance_noise, velocity)


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    config: SchedulerConfig = SchedulerConfig()

    def __post_init__(self):
        betas = make_betas(
            self.config.num_train_timesteps, self.config.beta_start, self.config.beta_end, self.config.beta_schedule
        )
        object.__setattr__(self, "alphas_cumprod", np.cumprod(1.0 - betas, axis=0).astype(np.float32))

    @classmethod
    def from_config(cls, config: dict) -> "DDPMScheduler":
        return cls(SchedulerConfig.from_config(config))

    def schedule(self, num_inference_steps: int) -> Schedule:
        return leading_timesteps(self.config.num_train_timesteps, num_inference_steps, self.config.steps_offset)

    def default_num_inference_steps(self) -> int:
        return self.config.num_train_timesteps

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        return add_noise(self.alphas_cumprod, sample, noise, t)

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """v-prediction target: v = sqrt(a_t) * noise - sqrt(1 - a_t) * sample."""
        return velocity(self.alphas_cumprod, sample, noise, t)

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor, schedule: Schedule,
             generator: StepGenerator = None, noise: torch.Tensor | None = None) -> torch.Tensor:
        """One ancestral step x_t -> x_{t_prev}. The noise is ``noise`` or a
        draw from ``generator`` (see :func:`.common.variance_noise`); it is
        drawn at t = 0 too, where its weight is 0, as the JAX step does."""
        cfg = self.config
        t = int(t)
        one = np.float32(1.0)
        prev_t = t - schedule.step_delta
        alpha_prod_t = self.alphas_cumprod[t]
        alpha_prod_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else one
        beta_prod_t = one - alpha_prod_t
        beta_prod_prev = one - alpha_prod_prev
        current_alpha_t = alpha_prod_t / alpha_prod_prev
        current_beta_t = one - current_alpha_t

        x0, _ = predict_x0_and_eps(sample, model_output, alpha_prod_t, cfg.prediction_type)
        if cfg.clip_sample:
            x0 = torch.clamp(x0, -cfg.clip_sample_range, cfg.clip_sample_range)

        x0_coeff = np.sqrt(alpha_prod_prev) * current_beta_t / beta_prod_t
        xt_coeff = np.sqrt(current_alpha_t) * beta_prod_prev / beta_prod_t
        prev_sample = float(x0_coeff) * x0 + float(xt_coeff) * sample

        variance = np.maximum(beta_prod_prev / beta_prod_t * current_beta_t, np.float32(1e-20))
        std = float(np.sqrt(variance)) if t > 0 else 0.0
        return prev_sample + std * variance_noise(sample, generator, noise)
