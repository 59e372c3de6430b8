"""Exponential moving average of parameters (port of ``audio_diffusion_tpu/models/ema.py``).

The decay schedule ``min(max_decay, 1 - (1 + step / inv_gamma)^-power)``
(defaults inv_gamma=1.0, power=0.75, max_decay=0.9999) is evaluated in f32,
as the JAX package evaluates it; the update runs in place under
``torch.no_grad()`` over lists of tensors, one multi-tensor launch per
operation on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EMA:
    inv_gamma: float = 1.0
    power: float = 0.75
    max_decay: float = 0.9999
    min_decay: float = 0.0

    def decay(self, step) -> float:
        """The decay at optimization step ``step``, f32 arithmetic, as a Python float."""
        one = np.float32(1.0)
        value = one - (one + np.float32(step) / np.float32(self.inv_gamma)) ** np.float32(-self.power)
        return float(np.clip(np.float32(value), np.float32(self.min_decay), np.float32(self.max_decay)))

    @torch.no_grad()
    def update(self, ema_params: Sequence[torch.Tensor], new_params: Sequence[torch.Tensor], step) -> float:
        """ema <- decay * ema + (1 - decay) * new, in place; returns the decay used."""
        d = self.decay(step)
        ema_params, new_params = list(ema_params), list(new_params)
        torch._foreach_mul_(ema_params, d)
        torch._foreach_add_(ema_params, torch._foreach_mul(new_params, float(np.float32(1.0) - np.float32(d))))
        return d
