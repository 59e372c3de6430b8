"""The plain reference of the benchmark's models, in float32 PyTorch.

A frozen, independent statement of the teticio audio-diffusion architectures
(diffusers' UNet2DModel / UNet2DConditionModel layout of the reference
``scripts/train_unet.py:115-159``, and the LDM KL-VAE decoder of
``config/ldm_autoencoder_kl.yaml``): plain ``torch`` operations, no kernel,
cache or CUDA graph, and nothing imported from the program under test. The
parameter names are the diffusers keys, so the benchmark hands the same
seeded state dict to the program and to this reference.

Every product (convolution, linear layer, both attention products) goes
through :class:`Arith`. ``Arith("float32")`` is the reference: float32 with
TF32 off (the caller turns TF32 off, ``pipeline.float32_exact``). ``Arith("fp8")``
is the control of the benchmark's check: the same model with every operand
of every product rounded to float8 e4m3 under a per-tensor scale, the
precision step below the configurations' bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor, back in float32; under autograd
    the rounding passes the gradient straight through."""
    d = x.detach()
    scale = d.abs().amax().clamp(min=1e-30) / FP8_MAX
    return x + ((d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale - d)


class Arith:
    """The products of the reference, in ``precision`` "float32" or "fp8"."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision!r}")
        self.precision = precision

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x) if self.precision == "fp8" else x

    def conv(self, x, conv: nn.Conv2d):
        return F.conv2d(self._q(x), self._q(conv.weight), conv.bias.float(), conv.stride, conv.padding)

    def linear(self, x, lin: nn.Linear):
        return F.linear(self._q(x), self._q(lin.weight), None if lin.bias is None else lin.bias.float())

    def matmul(self, a, b):
        return torch.matmul(self._q(a), self._q(b))


def _attention(arith: Arith, q, k, v):
    """softmax(q k^T / sqrt(d)) v over (..., N, d) queries and (..., M, d) keys and values."""
    s = arith.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return arith.matmul(torch.softmax(s, dim=-1), v)


def _gn(x, norm: nn.GroupNorm, silu: bool = False):
    y = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    return F.silu(y) if silu else y


class _Node(nn.Module):
    """A module that reaches the model's :class:`Arith` through its root."""

    def __init__(self, arith: Arith):
        super().__init__()
        object.__setattr__(self, "arith", arith)  # not a submodule


class ResnetBlock(_Node):
    """GroupNorm+SiLU, 3x3 conv, [+ the timestep projection], GroupNorm+SiLU, 3x3 conv, + shortcut."""

    def __init__(self, arith, cin, cout, temb_dim, groups, eps):
        super().__init__(arith)
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        a = self.arith
        h = a.conv(_gn(x, self.norm1, True), self.conv1)
        if temb is not None:
            h = h + a.linear(F.silu(temb), self.time_emb_proj)[:, :, None, None]
        h = a.conv(_gn(h, self.norm2, True), self.conv2)
        return (x if self.conv_shortcut is None else a.conv(x, self.conv_shortcut)) + h


class SpatialSelfAttention(_Node):
    """GroupNorm, q/k/v projections, (channels // head_dim) heads over H*W tokens, out projection, residual."""

    def __init__(self, arith, channels, head_dim, groups, eps, single_head=False):
        super().__init__(arith)
        self.heads = 1 if single_head else max(channels // head_dim, 1)
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q, self.to_k, self.to_v = (nn.Linear(channels, channels) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        a = self.arith
        b, c, h, w = x.shape
        y = _gn(x, self.group_norm).reshape(b, c, h * w).transpose(1, 2)

        def heads(t):
            return t.reshape(b, h * w, self.heads, c // self.heads).transpose(1, 2)

        o = _attention(a, heads(a.linear(y, self.to_q)), heads(a.linear(y, self.to_k)), heads(a.linear(y, self.to_v)))
        o = a.linear(o.transpose(1, 2).reshape(b, h * w, c), self.to_out[0])
        return o.transpose(1, 2).reshape(b, c, h, w) + x


class CrossAttention(_Node):
    """Bias-free q/k/v projections, ``heads`` heads of ``head_dim``, keys and values from ``context`` or x."""

    def __init__(self, arith, query_dim, heads, head_dim, context_dim=None):
        super().__init__(arith)
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        a = self.arith
        src = x if context is None else context

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.head_dim).transpose(1, 2)

        o = _attention(a, heads(a.linear(x, self.to_q)), heads(a.linear(src, self.to_k)),
                       heads(a.linear(src, self.to_v)))
        return a.linear(o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1), self.to_out[0])


class GEGLU(_Node):
    def __init__(self, arith, dim, inner):
        super().__init__(arith)
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.arith.linear(x, self.proj).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(_Node):
    def __init__(self, arith, dim, mult=4):
        super().__init__(arith)
        self.net = nn.ModuleList([GEGLU(arith, dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.arith.linear(self.net[0](x), self.net[2])


class TransformerBlock(_Node):
    """Pre-LayerNorm (eps 1e-6) self-attention, cross-attention and GEGLU feed-forward, each with a residual."""

    def __init__(self, arith, dim, heads, head_dim, context_dim):
        super().__init__(arith)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(arith, dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(arith, dim, heads, head_dim, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(arith, dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(_Node):
    """GroupNorm (eps 1e-6), linear proj_in, one TransformerBlock, linear proj_out, residual."""

    def __init__(self, arith, channels, heads, head_dim, context_dim, groups):
        super().__init__(arith)
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(arith, channels, heads, head_dim, context_dim)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        a = self.arith
        b, c, h, w = x.shape
        y = _gn(x, self.norm).reshape(b, c, h * w).transpose(1, 2)
        y = a.linear(self.transformer_blocks[0](a.linear(y, self.proj_in), context), self.proj_out)
        return y.transpose(1, 2).reshape(b, c, h, w) + x


class Resample(_Node):
    """Stride-2 3x3 conv (down; ``pad_right``: the LDM's asymmetric pad), or nearest x2 then a 3x3 conv (up)."""

    def __init__(self, arith, channels, down):
        super().__init__(arith)
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1, padding=1)

    def forward(self, x):
        return self.arith.conv(x if self.down else F.interpolate(x, scale_factor=2, mode="nearest"), self.conv)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos=True, freq_shift=0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([emb.cos(), emb.sin()] if flip_sin_to_cos else [emb.sin(), emb.cos()], dim=-1)


class UNet(_Node):
    """The UNet of a configuration's ``unet`` block: DownBlock2D / AttnDownBlock2D / CrossAttnDownBlock2D and
    their up counterparts; a conditional one (``cross_attention_dim``) takes an encoding per row and has a
    Transformer2D mid block. NHWC in, NHWC epsilon out, float32."""

    def __init__(self, cfg: dict, arith: Optional[Arith] = None):
        arith = arith or Arith()
        super().__init__(arith)
        self.cfg = cfg
        chs = tuple(cfg["block_out_channels"])
        ch0, temb_dim, n = chs[0], chs[0] * 4, len(chs)
        g, eps, hd = cfg.get("norm_num_groups", 32), cfg.get("norm_eps", 1e-5), cfg.get("attention_head_dim", 8)
        ctx = cfg.get("cross_attention_dim")
        self.conditional = ctx is not None

        def attn(kind, c):
            if kind.startswith("Attn"):
                return SpatialSelfAttention(arith, c, hd, g, eps)
            return Transformer2D(arith, c, hd, max(c // hd, 1), ctx, g)  # hd is the number of heads here

        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch0, temb_dim)
        self.time_embedding.linear_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(cfg.get("in_channels", 1), ch0, 3, padding=1)
        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["down_block_types"]):
            blk = nn.Module()
            blk.resnets, blk.attentions = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.get("layers_per_block", 2)):
                blk.resnets.append(ResnetBlock(arith, ch, chs[i], temb_dim, g, eps))
                if kind != "DownBlock2D":
                    blk.attentions.append(attn(kind, chs[i]))
                ch = chs[i]
                skips.append(ch)
            if i != n - 1:
                blk.downsamplers = nn.ModuleList([Resample(arith, ch, down=True)])
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock(arith, ch, ch, temb_dim, g, eps) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([attn("Cross" if self.conditional else "Attn", ch)])
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg["up_block_types"]):
            out = chs[::-1][i]
            blk = nn.Module()
            blk.resnets, blk.attentions = nn.ModuleList(), nn.ModuleList()
            for _ in range(cfg.get("layers_per_block", 2) + 1):
                blk.resnets.append(ResnetBlock(arith, ch + skips.pop(), out, temb_dim, g, eps))
                if kind != "UpBlock2D":
                    blk.attentions.append(attn(kind, out))
                ch = out
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([Resample(arith, out, down=False)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.get("out_channels", 1), 3, padding=1)

    def _attend(self, blk, j, x, context):
        m = blk.attentions[j]
        return m(x, context) if isinstance(m, Transformer2D) else m(x)

    def forward(self, sample: torch.Tensor, t, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``t``: one timestep for every row (an int), or one per row (a (B,) tensor)."""
        a, cfg = self.arith, self.cfg
        t = torch.full((1,), t, device=sample.device) if isinstance(t, int) else t.to(sample.device)
        temb = timestep_embedding(t, cfg["block_out_channels"][0], cfg.get("flip_sin_to_cos", True),
                                  cfg.get("freq_shift", 0))
        temb = a.linear(F.silu(a.linear(temb, self.time_embedding.linear_1)), self.time_embedding.linear_2)
        context = None if context is None else context.float()
        x = a.conv(sample.permute(0, 3, 1, 2).float(), self.conv_in)
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if len(blk.attentions):
                    x = self._attend(blk, j, x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self._attend(self.mid_block, 0, x, context)
        x = self.mid_block.resnets[1](x, temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = self._attend(blk, j, x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = a.conv(_gn(x, self.conv_norm_out, True), self.conv_out)
        return x.permute(0, 2, 3, 1)


class VAEDecoder(_Node):
    """``post_quant_conv`` and the KL-VAE decoder of a configuration's ``vae`` block: NHWC latents in, NHWC
    images in [-1, 1]-ish out, float32. Its parameter names are the diffusers AutoencoderKL's decode half."""

    def __init__(self, cfg: dict, arith: Optional[Arith] = None):
        arith = arith or Arith()
        super().__init__(arith)
        g, rev = cfg.get("norm_num_groups", 32), tuple(reversed(cfg["block_out_channels"]))
        lc = cfg.get("latent_channels", 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)
        dec = self.decoder = nn.Module()
        dec.conv_in = nn.Conv2d(lc, rev[0], 3, padding=1)
        dec.mid_block = nn.Module()
        dec.mid_block.resnets = nn.ModuleList([ResnetBlock(arith, rev[0], rev[0], 0, g, 1e-6) for _ in range(2)])
        dec.mid_block.attentions = nn.ModuleList([SpatialSelfAttention(arith, rev[0], 0, g, 1e-6, single_head=True)])
        dec.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.get("layers_per_block", 2) + 1):
                blk.resnets.append(ResnetBlock(arith, ch, out, 0, g, 1e-6))
                ch = out
            if i != len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Resample(arith, out, down=False)])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        dec.conv_out = nn.Conv2d(rev[-1], cfg.get("out_channels", 1), 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        a, dec = self.arith, self.decoder
        x = a.conv(a.conv(z.permute(0, 3, 1, 2).float(), self.post_quant_conv), dec.conv_in)
        x = dec.mid_block.resnets[0](x)
        x = dec.mid_block.attentions[0](x)
        x = dec.mid_block.resnets[1](x)
        for blk in dec.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return a.conv(_gn(x, dec.conv_norm_out, True), dec.conv_out).permute(0, 2, 3, 1)

    @staticmethod
    def keys_of(state_dict: dict) -> dict:
        """The decode half of a whole AutoencoderKL state dict."""
        return {k: v for k, v in state_dict.items() if k.startswith(("decoder.", "post_quant_conv."))}
