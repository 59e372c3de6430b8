"""The one generator of every traffic mix: a mix is a data file of parameters
(``benchmark/traffic/<name>.json``) that this module reads; its ``mode`` names
the loop that drives it (``benchmark/modes/<mode>.py``).

- ``closed``: one caller sends requests of ``batch`` rows back to back; request
  ``i`` draws its inputs (noise, the Griffin-Lim phase, encodings) on the
  device from (seed, i).
- ``open``: independent users, arriving at the due times of the arrival
  process the mix names (``benchmark/arrivals/<arrivals>.py``); request ``j``
  carries its own seed, drawn from the run's seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import named
from .weights import derive_seed, generator

REQUEST_TAG, USER_SEED_TAG = 100, 102


def closed_inputs(cfg: dict, mix: dict, seed: int, i: int, device) -> dict:
    """The inputs of closed-loop request ``i``: noise (B, h, w, c), gl_phase (B, frames, n_fft // 2 + 1) in
    radians and, for a conditional configuration, encoding (B, seq, dim)."""
    b = mix["batch"]
    u, mel = cfg["unet"], cfg["mel"]
    h, w = u["sample_size"]
    g = generator(device, seed, REQUEST_TAG, i)
    out = {"noise": torch.randn((b, h, w, u.get("in_channels", 1)), generator=g, device=device),
           "gl_phase": 2.0 * math.pi * torch.rand((b, mel["x_res"], mel["n_fft"] // 2 + 1), generator=g,
                                                  device=device)}
    if cfg.get("encoding"):
        e = cfg["encoding"]
        out["encoding"] = torch.randn((b, e["seq"], e["dim"]), generator=g, device=device)
    return out


def open_arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, from the arrival process the mix names
    (``benchmark/arrivals/<arrivals>.py``, whose ``due(mix, seed, seconds)`` reads the mix's parameters)."""
    return named.load("arrivals", mix["arrivals"]).due(mix, seed, seconds)


def user_seeds(seed: int, n: int) -> list:
    """Each open-loop request's own seed, in [0, 2**63)."""
    return [derive_seed(seed, USER_SEED_TAG, j) for j in range(n)]
