"""FLOPs, counted over the benchmark's own reference models (each family's ``flops``).

The definition (the one the port's ``utils/flops.py`` states): two FLOPs per
multiply-add of every matrix product and convolution the algorithm performs,
convolutions at their nominal taps (the taps on zero padding included), both
attention products, and nothing else: no normalisation, softmax, activation,
upsample, scheduler step or FFT. ``torch.utils.flop_counter.FlopCounterMode``
counts exactly that, here over the reference models built on the ``meta``
device, so the count depends on the configuration and the shapes alone.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn) -> int:
    """The FLOPs of ``fn()``, by the definition above."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
