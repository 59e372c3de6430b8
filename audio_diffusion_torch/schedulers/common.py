"""Shared diffusion-schedule math (port of ``audio_diffusion_tpu/schedulers/common.py``).

Numeric semantics match diffusers 0.24: linear betas 1e-4 -> 2e-2, "leading"
timestep spacing, epsilon prediction, ``clip_sample=True``. Tables are numpy;
per-step scalars are f32, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Iterator, NamedTuple, Sequence, Union

import numpy as np
import torch

from ..utils.config import ConfigMixin

# A row's whole chain of step noise is drawn in one call when it takes at most
# this many bytes (latent-256 at 50 steps: 200 KiB; pixel-256 DDPM at 1000
# steps: 256 MiB, so that one draws step by step).
ROW_CHAIN_BYTES = 16 << 20

StepGenerator = Union[torch.Generator, Sequence[torch.Generator], None]


def variance_noise(sample: torch.Tensor, generator: StepGenerator = None,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-step sampling noise for stochastic steps (DDPM, DDIM eta > 0).

    ``noise`` when injected (how tests hand both packages one draw). Else
    ``generator``: one ``torch.Generator`` draws one batch-shaped tensor, so
    row i depends on the batch layout like the reference's shared
    ``step_generator``; a sequence of B generators draws each row from its
    own, so a row's noise is the same alone or in any batch (the JAX
    package's per-row keys, common.py:25-54). torch cannot reproduce
    ``jax.random``, so only injected noise matches the JAX package."""
    if noise is not None:
        return noise.to(device=sample.device, dtype=sample.dtype)
    return _randn(tuple(sample.shape), sample.device, generator).to(sample.dtype)


def _randn(shape: tuple, device: torch.device, generator: StepGenerator) -> torch.Tensor:
    """A standard normal f32 draw of ``shape`` on ``device``: from one
    generator, or row i from the i-th of a sequence of per-row generators."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} per-row generators for a batch of {shape[0]}")
        return torch.stack([torch.randn(shape[1:], generator=g, device=g.device).to(device) for g in generator])
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def step_noises(shape: tuple, steps: int, device: torch.device, generator: StepGenerator = None,
                noise: torch.Tensor | None = None) -> Iterator[torch.Tensor]:
    """The variance noise of each of ``steps`` stochastic steps, (B, ...) = ``shape`` each.

    ``noise`` (steps, B, ...) yields its slices. One generator draws each
    step's batch when the step comes (the reference's order). A sequence of
    B per-row generators draws row i only from generator i, so the result is
    independent of the co-batch; to keep the launches at B per request, not
    B per step, a row whose whole chain fits ``ROW_CHAIN_BYTES`` is drawn at
    once as (steps, ...), else step by step. The choice depends on the row's
    shape and the step count only, never on the batch."""
    if noise is not None:
        noise = torch.as_tensor(noise)
        if noise.shape[0] < steps or tuple(noise.shape[1:]) != tuple(shape):
            raise ValueError(f"step_noise must be ({steps}, {', '.join(map(str, shape))}), "
                             f"got {tuple(noise.shape)}")
        for i in range(steps):
            yield noise[i].to(device=device, dtype=torch.float32)
        return
    if isinstance(generator, (list, tuple)) and steps * math.prod(shape[1:]) * 4 <= ROW_CHAIN_BYTES:
        chains = _randn((shape[0], steps, *shape[1:]), device, generator)  # row i: (steps, ...) from generator i
        yield from chains.transpose(0, 1)
        return
    for _ in range(steps):
        yield _randn(tuple(shape), device, generator)


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


@lru_cache(maxsize=16)
def _device_table(table_bytes: bytes, device: torch.device) -> torch.Tensor:
    """An f32 table on ``device``, copied from the host once per table and
    device: a pageable host-to-device copy on every call would stall the
    stream and cannot be captured in a CUDA graph."""
    return torch.frombuffer(bytearray(table_bytes), dtype=torch.float32).to(device)


def _alpha_at(alphas_cumprod: np.ndarray, sample: torch.Tensor, t) -> torch.Tensor:
    """``alphas_cumprod[t]`` on the sample's device, shaped to broadcast over
    it. An int ``t`` indexes the cached device table on the host side (a
    view, no copy); a tensor ``t`` gathers on the device."""
    table = _device_table(np.asarray(alphas_cumprod, dtype=np.float32).tobytes(), sample.device)
    a = table[int(t)] if isinstance(t, (int, np.integer)) else table[torch.as_tensor(t, device=sample.device)]
    while a.dim() < sample.dim():
        a = a[..., None]
    return a


def add_noise(alphas_cumprod: np.ndarray, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """Forward process: sqrt(a_t) * sample + sqrt(1 - a_t) * noise, with
    ``a_t = alphas_cumprod[t]`` for an int or a (B,) tensor ``t``."""
    a = _alpha_at(alphas_cumprod, sample, t)
    return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise


def velocity(alphas_cumprod: np.ndarray, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """The v-prediction training target sqrt(a_t) * noise - sqrt(1 - a_t) *
    sample (ddim.py:63-68, ddpm.py:61-65), ``t`` an int or a (B,) tensor."""
    a = _alpha_at(alphas_cumprod, sample, t)
    return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample


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
