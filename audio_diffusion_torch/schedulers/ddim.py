"""DDIM scheduler (port of ``audio_diffusion_tpu/schedulers/ddim.py``).

diffusers 0.24 semantics with ``set_alpha_to_one=True``. ``alphas_cumprod``
is computed in numpy float64 and cast to f32 (ddim.py:37-38), not by a torch
f32 cumprod; every per-step coefficient is then f32 arithmetic on the host,
so a step is a few elementwise ops on the device with the same constants the
JAX program computes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import (Schedule, SchedulerConfig, StepGenerator, add_noise, leading_timesteps, make_betas,
                     predict_x0_and_eps, variance_noise, velocity)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    config: SchedulerConfig = SchedulerConfig()
    set_alpha_to_one: bool = True

    def __post_init__(self):
        betas = make_betas(
            self.config.num_train_timesteps, self.config.beta_start, self.config.beta_end, self.config.beta_schedule
        )
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        object.__setattr__(self, "alphas_cumprod", alphas_cumprod.astype(np.float32))
        final = 1.0 if self.set_alpha_to_one else float(alphas_cumprod[0])
        object.__setattr__(self, "final_alpha_cumprod", np.float32(final))

    @classmethod
    def from_config(cls, config: dict) -> "DDIMScheduler":
        return cls(SchedulerConfig.from_config(config), set_alpha_to_one=config.get("set_alpha_to_one", True))

    def schedule(self, num_inference_steps: int) -> Schedule:
        return leading_timesteps(self.config.num_train_timesteps, num_inference_steps, self.config.steps_offset)

    def default_num_inference_steps(self) -> int:
        return 50

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        return add_noise(self.alphas_cumprod, sample, noise, t)

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """v-prediction target: v = sqrt(a_t) * noise - sqrt(1 - a_t) * sample."""
        return velocity(self.alphas_cumprod, sample, noise, t)

    def _alpha_prev(self, prev_t: int) -> np.float32:
        return self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor, schedule: Schedule,
             eta: float = 0.0, generator: StepGenerator = None,
             noise: torch.Tensor | None = None) -> torch.Tensor:
        """One deterministic (eta=0) or stochastic DDIM step x_t -> x_{t_prev}.
        For eta > 0 the variance noise is ``noise`` or a draw from
        ``generator`` (one, or one per row: see :func:`.common.variance_noise`)."""
        cfg = self.config
        t = int(t)
        one = np.float32(1.0)
        alpha_prod_t = self.alphas_cumprod[t]
        alpha_prod_prev = self._alpha_prev(t - schedule.step_delta)
        beta_prod_t = one - alpha_prod_t

        x0, eps = predict_x0_and_eps(sample, model_output, alpha_prod_t, cfg.prediction_type)
        if cfg.clip_sample:
            x0 = torch.clamp(x0, -cfg.clip_sample_range, cfg.clip_sample_range)

        variance = (one - alpha_prod_prev) / beta_prod_t * (one - alpha_prod_t / alpha_prod_prev)
        std_dev = np.float32(eta) * np.sqrt(variance)
        coef_dir = np.sqrt(np.maximum(one - alpha_prod_prev - std_dev * std_dev, np.float32(0.0)))
        prev_sample = float(np.sqrt(alpha_prod_prev)) * x0 + float(coef_dir) * eps
        if eta > 0:
            prev_sample = prev_sample + float(std_dev) * variance_noise(sample, generator, noise)
        return prev_sample

    def invert_step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
                    schedule: Schedule) -> torch.Tensor:
        """Closed-form reverse of the deterministic step (ddim.py:108-126):
        undo step t, then re-noise to t."""
        t = int(t)
        one = np.float32(1.0)
        alpha_prod_t = self.alphas_cumprod[t]
        alpha_prod_prev = self._alpha_prev(t - schedule.step_delta)
        beta_prod_t = one - alpha_prod_t
        direction = float(np.sqrt(one - alpha_prod_prev)) * model_output
        x0 = (sample - direction) / float(np.sqrt(alpha_prod_prev))
        return float(np.sqrt(alpha_prod_t)) * x0 + float(np.sqrt(beta_prod_t)) * model_output
