"""UNet2D for mel-spectrogram diffusion, unconditional and cross-attention
(port of ``audio_diffusion_tpu/models/unet2d.py``).

The public ``forward`` takes and returns NHWC like the flax module; inside,
activations are contiguous NCHW so a (batch, group) slab is one contiguous
run for the GroupNorm kernel. Parameters follow the diffusers key layout that
``audio_diffusion_tpu/utils/torch_export.py::export_unet`` writes, so
converted checkpoints (``utils/convert.py``) load with ``strict=True``.

Precision follows the JAX package: parameters stay f32 and each conv and
linear casts them to the compute dtype (``UNetConfig.dtype``); GroupNorm and
LayerNorm statistics are f32 with compute-dtype output; ``conv_out`` reads
compute-dtype-rounded operands and accumulates and emits f32.
``fused_groupnorm`` routes every ResnetBlock2D norm through
:func:`..ops.fused_groupnorm.fused_group_norm_silu`; SelfAttention2D always
goes through :func:`..ops.attention.multi_head_attention`. The conditional
blocks' ``CrossAttention`` is ``jax.nn.dot_product_attention`` in the JAX
package, XLA and not a Pallas kernel: here it is
:func:`..ops.attention.dot_product_attention` (SDPA on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, multi_head_attention
from ..ops.batch_invariant_conv2d import batch_invariant_conv2d
from ..ops.fused_groupnorm import fused_group_norm_silu
from ..utils.config import ConfigMixin

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class UNetConfig(ConfigMixin):
    """The JAX package's ``UNetConfig`` fields that change the function or
    its training, so ``config.json`` files are interchangeable. Its other
    fields (``norm_dtype``, ``fold_skip_concat``, ``dilated_upsample``) pick
    XLA/TPU formulations of the same function; ``from_config`` skips them.
    ``remat`` recomputes each block's activations in the backward instead of
    keeping them (:meth:`UNet2D.forward`)."""

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
    remat: bool = False

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


def conditional_config(sample_size=(256, 256), in_channels=1, out_channels=1, cross_attention_dim=100,
                       **kw) -> UNetConfig:
    """The reference's conditional architecture (train_unet.py:140-159)."""
    return UNetConfig(
        sample_size=sample_size,
        in_channels=in_channels,
        out_channels=out_channels,
        block_out_channels=(128, 256, 512, 512),
        down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
        cross_attention_dim=cross_attention_dim,
        **kw,
    )


# ------------------------------------------------------------------ layers

class Conv2d(nn.Conv2d):
    """nn.Conv2d whose f32 parameters are cast to the input's dtype per call.

    Inside the batcher's batch-invariant window (cuDNN off, as
    ``utils/batch_invariant.py::window`` sets it and every fused program's key
    records it) a bf16 call on the card takes
    :func:`..ops.batch_invariant_conv2d.batch_invariant_conv2d`, whose tiling
    never depends on the batch; it rounds the f32 parameters to bf16 itself."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.bfloat16 and not torch.backends.cudnn.enabled:
            return batch_invariant_conv2d(x.contiguous(), self.weight, self.bias, self.stride, self.padding)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear whose f32 parameters are cast to the input's dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, silu: bool = False) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=compute)``: f32 statistics and affine, output
    in x's dtype, with the SiLU (when asked) applied after that rounding."""
    y = F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` feeding a compute-dtype Dense: f32
    statistics and affine, rounded to x's dtype (the compute dtype)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(x.dtype)


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

    def forward(self, x: torch.Tensor, temb: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``temb`` holds one embedding per distinct timestep; ``rows`` gives
        each row of ``x`` its timestep's index (None: one timestep for all)."""
        h = self.conv1(self._norm_silu(x, self.norm1))
        t = self.time_emb_proj(F.silu(temb))
        h = h + (t if rows is None else t[rows])[:, :, None, None]
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
        return in_row_blocks(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        y = group_norm(x, self.group_norm).reshape(b, c, n).transpose(1, 2)  # (B, N, C)

        def heads(t):  # (B, N, C) -> a (B, heads, N, d) view, uncopied: the kernel takes the strides
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        o = multi_head_attention(heads(self.to_q(y)), heads(self.to_k(y)), heads(self.to_v(y)))
        # On the card o views a (B, N, heads, d) buffer, so this reshape copies nothing.
        o = self.to_out[0](o.transpose(1, 2).reshape(b, n, c))
        return o.transpose(1, 2).reshape(b, c, h, w) + x


# On the card, f32 attention blocks run on blocks of this many rows: see in_row_blocks.
ROW_BLOCK = 8


def in_row_blocks(fn, *rows: torch.Tensor) -> torch.Tensor:
    """``fn(*rows)`` for tensors whose dim 0 is the batch. For f32 tensors on
    the card ``fn`` runs on consecutive blocks of :data:`ROW_BLOCK` rows, the
    batch zero-padded up to a whole number of them, and the padding is
    dropped: every product inside then has one shape whatever the batch.
    cuBLAS picks its f32 kernel (split-K and the like) by the product's rows
    and batch count, so a row's f32 result would otherwise depend on its
    batch: the attention blocks' projections fold the batch into the GEMM's
    rows (chip_smoke.py's ``[tier]`` names those calls). bf16 runs in one
    call: its kernels give a row the same bits in any batch, and blocks would
    cost launches on the headline path. The CPU runs in one call too."""
    b = rows[0].shape[0]
    if rows[0].dtype != torch.float32 or not rows[0].is_cuda:
        return fn(*rows)
    pad = -b % ROW_BLOCK
    rows = [torch.cat([t.contiguous(), t.new_zeros((pad, *t.shape[1:]))]) if pad else t.contiguous() for t in rows]
    if b + pad == ROW_BLOCK:
        return fn(*rows)[:b]
    return torch.cat([fn(*block) for block in zip(*(t.split(ROW_BLOCK) for t in rows))])[:b]


def rowwise_linear(linear: Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear(x)`` for a bias-free ``linear`` and (B, S, I) ``x``, as one
    GEMM per row of the batch (a batched matmul against the weight broadcast
    over B). F.linear folds B into one GEMM of M=B*S rows, and a CPU BLAS picks
    another kernel for another M, so with S=1 a row's bits would depend on its
    batch; here each row's GEMM has M=S whatever B is."""
    w = linear.weight.to(x.dtype).t()
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


class CrossAttention(nn.Module):
    """Multi-head attention whose keys and values come from ``context`` (or
    from x itself when it is None); to_q/to_k/to_v have no bias."""

    def __init__(self, query_dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q = self.to_q(x).reshape(b, n, self.heads, self.head_dim)
        if context is None:
            k, v = self.to_k(x), self.to_v(x)
        else:  # the conditioning is a few tokens per row: its projections run row by row
            k, v = rowwise_linear(self.to_k, context), rowwise_linear(self.to_v, context)
        m = k.shape[1]
        k = k.reshape(b, m, self.heads, self.head_dim)
        v = v.reshape(b, m, self.heads, self.head_dim)
        o = dot_product_attention(q, k, v)
        return self.to_out[0](o.reshape(b, n, self.heads * self.head_dim))


class GEGLU(nn.Module):
    """``proj`` to twice the width, then the first half times the exact (erf)
    gelu of the second half (diffusers GEGLU; unet2d.py:355-369)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    """diffusers ``FeedForward``: ``net`` is [GEGLU, its Dropout slot (the
    identity at inference), Linear], so the keys are ff.net.0.proj and ff.net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: self-attention, cross-attention, GEGLU feed-forward,
    each behind a pre-LayerNorm (flax's epsilon 1e-6) and a residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(layer_norm(x, self.norm1))
        x = x + self.attn2(layer_norm(x, self.norm2), context)
        return x + self.ff(layer_norm(x, self.norm3))


class Transformer2D(nn.Module):
    """Spatial transformer over H*W tokens: GroupNorm (epsilon fixed at 1e-6,
    no SiLU), proj_in, one TransformerBlock, proj_out, and a residual
    (diffusers Transformer2DModel with ``use_linear_projection``)."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int, groups: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(channels, heads, head_dim, context_dim)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return in_row_blocks(self._forward, x, context)

    def _forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = group_norm(x, self.norm).reshape(b, c, h * w).transpose(1, 2)  # (B, N, C)
        y = self.proj_out(self.transformer_blocks[0](self.proj_in(y), context))
        return y.transpose(1, 2).reshape(b, c, h, w) + x


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


_BLOCK_TYPES = ("DownBlock2D", "AttnDownBlock2D", "CrossAttnDownBlock2D",
                "UpBlock2D", "AttnUpBlock2D", "CrossAttnUpBlock2D")
MAX_ATTENTION_TOKENS = 16384  # 128x128: the JAX package's feasibility limit (unet2d.py:586-603)


def _check_attention_tokens(cfg: UNetConfig, h: int, w: int) -> None:
    """A level attending over N tokens computes N^2 logits per head: refuse
    inputs whose attention levels exceed MAX_ATTENTION_TOKENS, with the JAX
    package's message and fix (the conditional architecture attends at its
    first level, so it is meant for VAE latents, not pixels)."""
    levels = list(zip(cfg.down_block_types, reversed(cfg.up_block_types)))
    deepest = len(cfg.block_out_channels) - 1
    for i, bt in enumerate(levels + [("mid-attention", "mid-attention")]):
        i = min(i, deepest)  # the mid block runs at the deepest level
        if any("ttn" in b for b in bt):
            tokens = (h >> i) * (w >> i)
            if tokens > MAX_ATTENTION_TOKENS:
                raise ValueError(
                    f"{'/'.join(set(bt))} at level {i} would attend over {tokens} tokens for input {h}x{w} — "
                    f"infeasible ({tokens}^2 logits/head). Train this architecture over VAE latents instead "
                    f"(train_unet --vae, the reference's conditional-latent recipe) or reduce the resolution.")


def _attend(attn: nn.Module, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
    return attn(x, context) if isinstance(attn, Transformer2D) else attn(x)


def _called(fn, *args):
    return fn(*args)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


# ----------------------------------------------------------------------- UNet

class UNet2D(nn.Module):
    """Unconditional or conditional UNet; ``config.cross_attention_dim`` makes
    the CrossAttn blocks and the mid block ``Transformer2D``s (reference:
    train_unet.py:115-159). Built on the CPU; move it with ``.to(device)``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        for bt in config.down_block_types + config.up_block_types:
            if bt not in _BLOCK_TYPES:
                raise ValueError(f"unknown block type {bt!r}")
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        g, eps, fused, hd = cfg.norm_num_groups, cfg.norm_eps, cfg.fused_groupnorm, cfg.attention_head_dim
        n = len(cfg.block_out_channels)

        def transformer(ch):
            # diffusers 0.12-0.24 UNet2DConditionModel: attention_head_dim is the NUMBER of heads here,
            # the opposite of SelfAttention2D's convention (unet2d.py:544-552)
            return Transformer2D(ch, hd, max(ch // hd, 1), cfg.cross_attention_dim, g)

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
                elif bt == "CrossAttnDownBlock2D":
                    blk.attentions.append(transformer(out_ch))
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
        self.mid_block.attentions = nn.ModuleList([transformer(mid_ch) if cfg.is_conditional
                                                   else SelfAttention2D(mid_ch, hd, g, eps)])

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
                elif bt == "CrossAttnUpBlock2D":
                    blk.attentions.append(transformer(out_ch))
                ch = out_ch
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Args:
            sample: (B, H, W, C) noisy images, NHWC.
            timesteps: scalar (one for every row) or (B,) diffusion timesteps.
            encoder_hidden_states: (B, seq, cross_attention_dim) conditioning;
                required by a conditional UNet, ignored by an unconditional one.
        Returns:
            (B, H, W, out_channels) f32 prediction (epsilon by default), NHWC.
        """
        cfg = self.config
        dtype = cfg.compute_dtype
        if cfg.is_conditional and encoder_hidden_states is None:
            raise ValueError("conditional UNet requires encoder_hidden_states")
        factor = 2 ** (len(cfg.block_out_channels) - 1)
        if sample.shape[1] % factor or sample.shape[2] % factor:
            raise ValueError(f"sample spatial dims {tuple(sample.shape[1:3])} must be divisible by {factor} "
                             "(2^(num_blocks-1)) or the up-path skip shapes break")
        _check_attention_tokens(cfg, sample.shape[1], sample.shape[2])
        context = None if encoder_hidden_states is None else encoder_hidden_states.to(dtype)
        # The time path runs once per distinct timestep and is gathered per row, so its GEMMs see the
        # same M whatever the batch: a CPU BLAS picks another kernel for M=4 than for M=2, and a row's
        # bits would then depend on its batch. A single timestep (the pipeline's scalar) needs no
        # torch.unique, which would wait for the device and cannot be captured in a CUDA graph.
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.numel() == 1:
            steps, rows = timesteps.reshape(1), None
        else:
            steps, rows = torch.unique(timesteps, return_inverse=True)

        temb = timestep_embedding(steps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))

        # remat: each ResnetBlock2D, SelfAttention2D and Transformer2D keeps only its inputs, and the
        # backward runs it again (nn.remat at unet2d.py:613-616). No block draws random numbers, so the RNG
        # state is not stashed around each of them: on a host-bound step that would cost host time for
        # nothing. Without grad nothing would be kept anyway, and the blocks run as they are.
        block = _checkpointed if cfg.remat and torch.is_grad_enabled() else _called

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype).contiguous())
        n = len(cfg.block_out_channels)
        skips = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, res in enumerate(blk.resnets):
                x = block(res, x, temb, rows)
                if len(blk.attentions):
                    x = block(_attend, blk.attentions[j], x, context)
                skips.append(x)
            if i != n - 1:
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = block(self.mid_block.resnets[0], x, temb, rows)
        x = block(_attend, self.mid_block.attentions[0], x, context)
        x = block(self.mid_block.resnets[1], x, temb, rows)

        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                x = block(res, torch.cat([x, skips.pop()], dim=1), temb, rows)
                if len(blk.attentions):
                    x = block(_attend, blk.attentions[j], x, context)
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
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
