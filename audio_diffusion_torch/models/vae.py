"""AutoencoderKL for latent audio diffusion (port of ``audio_diffusion_tpu/models/vae.py``).

The public ``encode``/``decode`` take and return NHWC like the flax module;
inside, activations are NCHW. Parameters follow the diffusers AutoencoderKL
key layout of ``torch_export.py::export_vae``. Precision follows the JAX
package: f32 parameters cast per op to the compute dtype, GroupNorm (eps
1e-6) with f32 statistics and compute-dtype output, f32 ``conv_out``, and f32
``quant_conv``/``post_quant_conv`` (they see f32 inputs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.config import ConfigMixin
from .unet2d import _DTYPES, Conv2d, Linear, Upsample2D, group_norm, in_row_blocks, init_flax_defaults


@dataclasses.dataclass(frozen=True)
class VAEConfig(ConfigMixin):
    in_channels: int = 1
    out_channels: int = 1
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)  # ch * ch_mult
    layers_per_block: int = 2
    latent_channels: int = 1
    sample_size: int = 256
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: str = "float32"

    config_name = "config.json"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def num_down(self) -> int:
        return len(self.block_out_channels) - 1

    def latent_hw(self, h: int, w: int) -> Tuple[int, int]:
        f = 2**self.num_down
        return h // f, w // f


class DiagonalGaussian:
    """Latent distribution returned by ``encode`` (diffusers
    ``DiagonalGaussianDistribution``, logvar clamped to [-30, 20]). NHWC."""

    def __init__(self, mean: torch.Tensor, logvar: torch.Tensor):
        self.mean = mean
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None, eps: torch.Tensor | None = None) -> torch.Tensor:
        """mean + std * eps, with eps a standard normal draw like ``mean`` from
        ``generator`` unless handed in (how tests give both packages one draw)."""
        if eps is None:
            device = generator.device if generator is not None else self.mean.device
            eps = torch.randn(self.mean.shape, generator=generator, device=device, dtype=self.mean.dtype)
        return self.mean + self.std * eps.to(device=self.mean.device, dtype=self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over the non-batch axes (vae.py:69-71)."""
        return 0.5 * torch.sum(self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar, dim=(1, 2, 3))


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(group_norm(x, self.norm1, silu=True))
        h = self.conv2(group_norm(h, self.norm2, silu=True))
        res = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return res + h


class VAEAttention(nn.Module):
    """Single-head mid-block attention (LDM AttnBlock), scores and softmax in f32."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return in_row_blocks(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm(x, self.group_norm).reshape(b, c, h * w).transpose(1, 2)  # (B, N, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        s = torch.bmm(q.float(), k.float().transpose(1, 2)) * (1.0 / math.sqrt(c))
        o = torch.bmm(torch.softmax(s, dim=-1).to(v.dtype), v)
        o = self.to_out[0](o)
        return o.transpose(1, 2).reshape(b, c, h, w) + x


def _mid_block(channels: int, groups: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups),
                                 VAEResnetBlock(channels, channels, groups)])
    mid.attentions = nn.ModuleList([VAEAttention(channels, groups)])
    return mid


class Downsample(nn.Module):
    """LDM downsample: asymmetric ((0,1),(0,1)) pad, then a stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        g, chs = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = chs[0]
        for i, out_ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(VAEResnetBlock(ch, out_ch, g))
                ch = out_ch
            if i != len(chs) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(out_ch)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> NCHW f32 moments."""
        x = self.conv_in(x.to(self.config.compute_dtype))
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        x = group_norm(x, self.conv_norm_out, silu=True)
        return self.conv_out(x.float())


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        g, rev = cfg.norm_num_groups, tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g)
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(VAEResnetBlock(ch, out_ch, g))
                ch = out_ch
            if i != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> NCHW f32 images."""
        x = self.conv_in(z.to(self.config.compute_dtype))
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = group_norm(x, self.conv_norm_out, silu=True)
        return self.conv_out(x.float())


class AutoencoderKL(nn.Module):
    """KL autoencoder. ``encode`` returns a :class:`DiagonalGaussian`;
    ``decode`` maps latents back to images. Both NHWC."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).float()))
        h = h.permute(0, 2, 3, 1)
        mean, logvar = torch.chunk(h, 2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2).float()))
        return x.permute(0, 2, 3, 1).contiguous()

    def init_params(self, generator: torch.Generator) -> "AutoencoderKL":
        """Seeded random init with flax's defaults (see ``init_flax_defaults``)."""
        init_flax_defaults(self, generator)
        return self
