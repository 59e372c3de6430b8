"""The one generator of every traffic mix: a mix is a data file of parameters
(``benchmark/traffic/<name>.json``) that this module reads; its ``mode`` names
the loop that drives it (``benchmark/modes/<mode>.py``).

- ``closed``: one caller sends requests of ``batch`` rows back to back; request
  ``i`` draws its inputs (noise, the Griffin-Lim phase, whatever else the
  configuration's model family takes) on the device from (seed, i).
- ``open``: independent users, arriving at the due times of the arrival
  process the mix names (``benchmark/arrivals/<arrivals>.py``); request ``j``
  carries its own seed, drawn from the run's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import named
from .weights import derive_seed, generator

REQUEST_TAG, USER_SEED_TAG = 100, 102


def request_generator(device, seed: int, i: int) -> torch.Generator:
    """The generator closed-loop request ``i``'s inputs are drawn from."""
    return generator(device, seed, REQUEST_TAG, i)


def closed_inputs(cfg: dict, mix: dict, seed: int, i: int, device) -> dict:
    """The inputs of closed-loop request ``i``: the per-row tensors of the configuration's family, batch first
    (``families/<family>.py::inputs``)."""
    return named.family(cfg).inputs(cfg, mix, seed, i, device)


def open_arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times in seconds from the window's start, ascending, from the arrival process the mix names
    (``benchmark/arrivals/<arrivals>.py``, whose ``due(mix, seed, seconds)`` reads the mix's parameters)."""
    return named.load("arrivals", mix["arrivals"]).due(mix, seed, seconds)


def user_seeds(seed: int, n: int) -> list:
    """Each open-loop request's own seed, in [0, 2**63)."""
    return [derive_seed(seed, USER_SEED_TAG, j) for j in range(n)]
