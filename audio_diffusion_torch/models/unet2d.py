"""UNet2D for mel-spectrogram diffusion, unconditional part
(port of ``audio_diffusion_tpu/models/unet2d.py``).

The public ``forward`` takes and returns NHWC like the flax module; inside,
activations are contiguous NCHW so a (batch, group) slab is one contiguous
run for the GroupNorm kernel. Parameters follow the diffusers key layout that
``audio_diffusion_tpu/utils/torch_export.py::export_unet`` writes, so
converted checkpoints (``utils/convert.py``) load with ``strict=True``.

Precision follows the JAX package: parameters stay f32 and each conv and
linear casts them to the compute dtype (``UNetConfig.dtype``); GroupNorm
statistics are f32 with compute-dtype output; ``conv_out`` reads
compute-dtype-rounded operands and accumulates and emits f32.
``fused_groupnorm`` routes every ResnetBlock2D norm through
:func:`..ops.fused_groupnorm.fused_group_norm_silu`; SelfAttention2D always
goes through :func:`..ops.attention.multi_head_attention`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.fused_groupnorm import fused_group_norm_silu
from ..utils.config import ConfigMixin

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class UNetConfig(ConfigMixin):
    """The JAX package's ``UNetConfig`` fields that change the function, so
    ``config.json`` files are interchangeable. Its other fields (``norm_dtype``,
    ``fold_skip_concat``, ``dilated_upsample``, ``remat``) pick XLA/TPU
    formulations of the same function; ``from_config`` skips them."""

    sample_size: Tuple[int, int] = (256, 256)
    in_channels: int = 1
    out_channels: int = 1
    layers_per_block: int = 2
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "DownBlock2D",
        "DownBlock2D",
        "DownBlock2D",
        "AttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "AttnUpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
        "UpBlock2D",
    )
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: Optional[int] = None
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    fused_groupnorm: bool = False

    config_name = "config.json"

    @property
    def is_conditional(self) -> bool:
        return self.cross_attention_dim is not None

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def sample_hw(self) -> Tuple[int, int]:
        s = self.sample_size
        return (s, s) if isinstance(s, int) else tuple(s)


def unconditional_config(sample_size=(256, 256), in_channels=1, out_channels=1, **kw) -> UNetConfig:
    """The reference's unconditional architecture (train_unet.py:115-137)."""
    return UNetConfig(sample_size=sample_size, in_channels=in_channels, out_channels=out_channels, **kw)


# ------------------------------------------------------------------ layers

class Conv2d(nn.Conv2d):
    """nn.Conv2d whose f32 parameters are cast to the input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear whose f32 parameters are cast to the input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, silu: bool = False) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=compute)``: f32 statistics and affine, output
    in x's dtype, with the SiLU (when asked) applied after that rounding."""
    y = F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)
    return F.silu(y) if silu else y


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``get_timestep_embedding`` math), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """Pre-norm ResNet block with a timestep projection. With ``fused_norm``
    both norms run the fused GroupNorm+SiLU kernel on the compute-dtype input."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, groups: int = 32,
                 eps: float = 1e-5, fused_norm: bool = False):
        super().__init__()
        self.groups, self.eps, self.fused_norm = groups, eps, fused_norm
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def _norm_silu(self, x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
        if self.fused_norm:
            return fused_group_norm_silu(x.contiguous(), norm.weight, norm.bias, self.groups, self.eps)
        return group_norm(x, norm, silu=True)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self._norm_silu(x, self.norm1))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self._norm_silu(h, self.norm2))
        res = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return res + h


class SelfAttention2D(nn.Module):
    """Spatial self-attention over H*W tokens with a residual connection,
    (channels // head_dim) heads (diffusers ``Attention`` in Attn blocks)."""

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.heads = max(channels // head_dim, 1)
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        y = group_norm(x, self.group_norm).reshape(b, c, n).transpose(1, 2)  # (B, N, C)

        def heads(t):  # (B, N, C) -> a (B, heads, N, d) view, uncopied: the kernel takes the strides
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        o = multi_head_attention(heads(self.to_q(y)), heads(self.to_k(y)), heads(self.to_v(y)))
        # On the card o views a (B, N, heads, d) buffer, so this reshape copies nothing.
        o = self.to_out[0](o.transpose(1, 2).reshape(b, n, c))
        return o.transpose(1, 2).reshape(b, c, h, w) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 followed by a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _check_block_type(block_type: str) -> None:
    if "CrossAttn" in block_type:
        raise NotImplementedError(f"{block_type}: the conditional tier waits (ROADMAP Queue 1 item 9)")
    if block_type not in ("DownBlock2D", "AttnDownBlock2D", "UpBlock2D", "AttnUpBlock2D"):
        raise ValueError(f"unknown block type {block_type!r}")


# ----------------------------------------------------------------------- UNet

class UNet2D(nn.Module):
    """Unconditional UNet (reference: train_unet.py:115-137). Built on the CPU;
    move it with ``.to(device)``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.is_conditional:
            raise NotImplementedError("conditional UNet: waits for ROADMAP Queue 1 item 9")
        for bt in config.down_block_types + config.up_block_types:
            _check_block_type(bt)
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        g, eps, fused, hd = cfg.norm_num_groups, cfg.norm_eps, cfg.fused_groupnorm, cfg.attention_head_dim
        n = len(cfg.block_out_channels)

        self.time_embedding = TimestepEmbedding(ch0, temb_dim)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)

        skip_channels = [ch0]
        self.down_blocks = nn.ModuleList()
        ch = ch0
        for i, bt in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(ch, out_ch, temb_dim, g, eps, fused))
                if bt == "AttnDownBlock2D":
                    blk.attentions.append(SelfAttention2D(out_ch, hd, g, eps))
                ch = out_ch
                skip_channels.append(out_ch)
            if i != n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(out_ch)])
                skip_channels.append(out_ch)
            self.down_blocks.append(blk)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(mid_ch, mid_ch, temb_dim, g, eps, fused),
                                                ResnetBlock2D(mid_ch, mid_ch, temb_dim, g, eps, fused)])
        self.mid_block.attentions = nn.ModuleList([SelfAttention2D(mid_ch, hd, g, eps)])

        self.up_blocks = nn.ModuleList()
        reversed_ch = tuple(reversed(cfg.block_out_channels))
        ch = mid_ch
        for i, bt in enumerate(cfg.up_block_types):
            out_ch = reversed_ch[i]
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(ch + skip_channels.pop(), out_ch, temb_dim, g, eps, fused))
                if bt == "AttnUpBlock2D":
                    blk.attentions.append(SelfAttention2D(out_ch, hd, g, eps))
                ch = out_ch
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """Args:
            sample: (B, H, W, C) noisy images, NHWC.
            timesteps: scalar or (B,) diffusion timesteps.
        Returns:
            (B, H, W, out_channels) f32 prediction (epsilon by default), NHWC.
        """
        cfg = self.config
        dtype = cfg.compute_dtype
        factor = 2 ** (len(cfg.block_out_channels) - 1)
        if sample.shape[1] % factor or sample.shape[2] % factor:
            raise ValueError(f"sample spatial dims {tuple(sample.shape[1:3])} must be divisible by {factor} "
                             "(2^(num_blocks-1)) or the up-path skip shapes break")
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])

        temb = timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype).contiguous())
        n = len(cfg.block_out_channels)
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x)
                skips.append(x)
            if i != n - 1:
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, temb)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = blk.attentions[j](x)
            if i != n - 1:
                x = blk.upsamplers[0](x)

        x = group_norm(x, self.conv_norm_out, silu=True)
        # f32-accumulating conv over compute-dtype-rounded operands (unet2d.py:477-527).
        w = self.conv_out.weight.to(dtype).float()
        x = F.conv2d(x.float(), w, self.conv_out.bias.float(), padding=1)
        return x.permute(0, 2, 3, 1).contiguous()

    def init_params(self, generator: torch.Generator) -> "UNet2D":
        """Seeded random init with flax's defaults, as ``UNet2D.init_params``:
        see :func:`init_flax_defaults`."""
        init_flax_defaults(self, generator)
        return self


@torch.no_grad()
def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """flax initializers: conv and dense kernels lecun_normal (truncated
    normal, std sqrt(1/fan_in)/.8796, cut at 2 std), biases zero, norm scale
    one and bias zero. Draws come from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
