"""Seeded weights, drawn on the device in a few large calls.

A model's parameters are split into groups (the UNet; the VAE's decode half;
the VAE's encode half); each group is one truncated-normal draw from its own
generator, cut into the group's matrices in the order of their names. flax's
default initialisers are followed: every convolution and linear kernel
``N(0, 1)`` cut at 2 standard deviations and scaled to ``sqrt(1 / fan_in) /
0.8796`` (so its standard deviation is ``sqrt(1 / fan_in)``), every bias
zero, every norm scale one; a configuration's ``weights.skeleton`` then lays
a structure over the UNet's draw (:func:`identity_denoiser`). The same seed gives the same values, whatever
else is drawn, so the reference regenerates the weights it needs after the
program's state is freed instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

TRUNC_STD = 0.87962566103423978  # the standard deviation of N(0, 1) cut at +-2


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for (``seed``, ``tags``); ``seed`` may be any non-negative integer."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, *map(int, tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


def draw(spec: Iterable[Tuple[str, Tuple[int, ...]]], device, seed: int, tag: int) -> Dict[str, torch.Tensor]:
    """float32 tensors for the (name, shape) pairs of ``spec``, on ``device``."""
    spec = sorted((name, tuple(shape)) for name, shape in spec)
    mats = [(n, s) for n, s in spec if len(s) >= 2]
    total = sum(math.prod(s) for _, s in mats)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator(device, seed, tag))
    out, offset = {}, 0
    for name, shape in spec:
        if len(shape) >= 2:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD)
            offset += n
        elif name.endswith(".weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


UNET_TAG, VAE_DECODE_TAG, VAE_ENCODE_TAG = 1, 2, 3
DECODE_PREFIXES = ("decoder.", "post_quant_conv.")


BRANCH_OUTPUTS = ("conv2.weight", "to_out.0.weight", "proj_out.weight", "ff.net.2.weight")


def identity_denoiser(state: Dict[str, torch.Tensor], branch_gain: float = 1.0) -> None:
    """Give a seeded UNet the skeleton of the denoiser of data at 0, whose epsilon is its input: ``conv_in``
    writes x and -x into channel pairs, the last up block's 1x1 shortcuts pass ``conv_in``'s skip through,
    and ``conv_out`` takes SiLU(x) - SiLU(-x) = x back out of the pairs. Every other tensor stays random and
    adds its part, each residual branch's output layer (:data:`BRANCH_OUTPUTS`) scaled by ``branch_gain``.
    Without it a random UNet's 50 DDIM steps amplify rounding until a bfloat16 run and a float32 one share
    nothing (PERF.md, section 6)."""
    w = state["conv_in.weight"]
    c0 = w.shape[0]
    w.zero_()
    w[0::2, 0, 1, 1], w[1::2, 0, 1, 1] = 1.0, -1.0
    w = state["conv_out.weight"]
    w.zero_()
    w[:, 0::2, 1, 1], w[:, 1::2, 1, 1] = 2.0 / c0, -2.0 / c0
    last = max(int(k.split(".")[1]) for k in state if k.startswith("up_blocks."))
    for name, w in state.items():
        if name.startswith(f"up_blocks.{last}.") and name.endswith("conv_shortcut.weight"):
            w.zero_()
            w[:, w.shape[1] - c0:, 0, 0] = torch.eye(c0, device=w.device)
        elif name.endswith(BRANCH_OUTPUTS):
            w.mul_(branch_gain)


def unet_state(shapes: Dict[str, tuple], device, seed: int, layout: Optional[dict] = None
               ) -> Dict[str, torch.Tensor]:
    """The UNet's state; ``layout`` (the configuration's ``weights``) lays the ``identity_denoiser`` skeleton
    over the random draw, with its other arguments."""
    out = draw(shapes.items(), device, seed, UNET_TAG)
    layout = dict(layout or {})
    skeleton = layout.pop("skeleton", None)
    if skeleton not in (None, "identity_denoiser"):
        raise ValueError(f"no weights skeleton {skeleton!r}")
    if skeleton:
        identity_denoiser(out, **layout)
    return out


def vae_state(shapes: Dict[str, tuple], device, seed: int) -> Dict[str, torch.Tensor]:
    """The VAE's state: its decode half from one draw and its encode half, when asked for, from another."""
    dec = {k: v for k, v in shapes.items() if k.startswith(DECODE_PREFIXES)}
    enc = {k: v for k, v in shapes.items() if not k.startswith(DECODE_PREFIXES)}
    out = draw(dec.items(), device, seed, VAE_DECODE_TAG)
    if enc:
        out.update(draw(enc.items(), device, seed, VAE_ENCODE_TAG))
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def filled(make, config, device, state_fn, seed: int) -> torch.nn.Module:
    """``make(config)`` made on the ``meta`` device, given storage on ``device`` and filled with
    ``state_fn(shapes, device, seed)``, in eval mode: nothing is initialised on the host and copied."""
    with torch.device("meta"):
        module = make(config)
    module = module.to_empty(device=device)
    module.load_state_dict(state_fn(shapes_of(module), device, seed), strict=True)
    return module.eval()
