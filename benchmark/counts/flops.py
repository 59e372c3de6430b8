"""FLOPs of a request and of its stages, counted over the benchmark's own reference models.

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

from ..reference.models import UNet, VAEDecoder


def _count(fn) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def unet_forward(cfg: dict, batch: int) -> int:
    """One UNet forward of ``batch`` rows at one timestep (a conditional UNet with its encoding)."""
    u = cfg["unet"]
    with torch.device("meta"):
        model = UNet(u)
        h, w = u["sample_size"]
        x = torch.zeros((batch, h, w, u.get("in_channels", 1)))
        enc = cfg.get("encoding")
        ctx = torch.zeros((batch, enc["seq"], enc["dim"])) if enc else None
        return _count(lambda: model(x, 0, ctx))


def vae_decode(cfg: dict, batch: int) -> int:
    v, u = cfg["vae"], cfg["unet"]
    with torch.device("meta"):
        model = VAEDecoder(v)
        h, w = u["sample_size"]
        return _count(lambda: model(torch.zeros((batch, h, w, v.get("latent_channels", 1)))))


def request(cfg: dict, batch: int, steps: int) -> dict:
    """{"denoise", "vae_decode", "total"} FLOPs of one request of ``batch`` rows."""
    out = {"denoise": steps * unet_forward(cfg, batch), "vae_decode": vae_decode(cfg, batch) if cfg.get("vae") else 0}
    out["total"] = out["denoise"] + out["vae_decode"]
    return out
