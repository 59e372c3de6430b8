"""Perceptual distances for VAE training (port of ``audio_diffusion_tpu/training/perceptual.py``).

:func:`perceptual_distance` is the LPIPS formula (Zhang et al. 2018, eq. 1,
uniform channel weights) over a fixed, randomly initialised VGG-style
feature stack: pretrained VGG weights cannot be fetched. The JAX module's
docstring records what that stack does and does not measure. :func:`dssim`
is structural dissimilarity (1 - SSIM, Wang et al. 2004: 11x11 Gaussian
window, sigma 1.5, K1/K2 = 0.01/0.03), borders cropped.

:func:`init_perceptual_params` draws its features from a ``torch.Generator``,
so one seed gives other features here than ``jax.random`` gives in the JAX
package; to compare the two, convert the JAX tree with
``utils.convert.perceptual_params``. Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# VGG16-like stage widths at the five LPIPS tap points, halved (perceptual.py:52-60).
_STAGE_CHANNELS: Sequence[int] = (32, 64, 128, 256, 256)
_CONVS_PER_STAGE: Sequence[int] = (2, 2, 3, 3, 3)


def init_perceptual_params(generator: torch.Generator, in_channels: int = 1) -> List[List[torch.Tensor]]:
    """Fixed random He-initialised 3x3 conv kernels (OIHW), one list per stage; constants, never trained."""
    params: List[List[torch.Tensor]] = []
    c_in = in_channels
    for ch, n_convs in zip(_STAGE_CHANNELS, _CONVS_PER_STAGE):
        stage = []
        for _ in range(n_convs):
            w = torch.randn((ch, c_in, 3, 3), generator=generator, device=generator.device)
            stage.append(w * float(np.sqrt(2.0 / (3 * 3 * c_in))))
            c_in = ch
        params.append(stage)
    return params


def _features(params: List[List[torch.Tensor]], x: torch.Tensor) -> List[torch.Tensor]:
    """Five NCHW feature maps, one per stage, 2x2 max pooling between stages."""
    taps = []
    for i, stage in enumerate(params):
        if i > 0:
            x = F.max_pool2d(x, 2, 2)
        for w in stage:
            x = F.relu(F.conv2d(x, w.to(x.dtype), padding=1))
        taps.append(x)
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(torch.square(f), dim=1, keepdim=True) + eps)


def perceptual_distance(params, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS distance between NHWC batches: the mean over the batch of the
    summed per-layer normalised feature MSE; differentiable in ``a`` and ``b``."""
    fa = _features(params, a.permute(0, 3, 1, 2))
    fb = _features(params, b.permute(0, 3, 1, 2))
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    for xa, xb in zip(fa, fb):
        diff = _unit_normalize(xa.float()) - _unit_normalize(xb.float())
        total = total + torch.mean(torch.sum(torch.square(diff), dim=1))
    return total


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-0.5 * np.square(x / sigma))
    g /= g.sum()
    return (g[:, None] * g[None, :]).astype(np.float32)


def _depthwise(x: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """Per-channel VALID conv of NCHW ``x`` with one 2-D kernel."""
    c = x.shape[1]
    return F.conv2d(x, k2d[None, None].expand(c, 1, *k2d.shape), groups=c)


def dssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Structural dissimilarity ``1 - mean(SSIM)`` between NHWC batches
    (perceptual.py:138-165): C1=(0.01 R)^2, C2=(0.03 R)^2 with ``data_range``
    R = 2 for [-1, 1] images; moments not clamped. Requires H, W >= 11."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = torch.from_numpy(_gaussian_window()).to(a.device)
    mu_a = _depthwise(a, k)
    mu_b = _depthwise(b, k)
    var_a = _depthwise(a * a, k) - torch.square(mu_a)
    var_b = _depthwise(b * b, k) - torch.square(mu_b)
    cov = _depthwise(a * b, k) - mu_a * mu_b
    lum = (2.0 * mu_a * mu_b + c1) / (torch.square(mu_a) + torch.square(mu_b) + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    return 1.0 - torch.mean(lum * cs)
