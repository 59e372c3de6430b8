"""The calls a UNet forward makes to the program's two hand-written kernels, from the configuration's
shapes, and each call's least time on the card.

- GroupNorm+SiLU (``csrc/group_norm_silu.cu``): the two norms of every
  ResnetBlock2D when ``fused_groupnorm`` is on; one call reads x once and
  writes y once in the compute dtype, and reads the f32 scale and bias.
  About 8 f32 operations an element (the two sums, the normalisation, the
  affine and SiLU's product and division), outside the tensor cores.
- Many-small-heads attention (``csrc/mha.cu``): every SelfAttention2D of an
  unconditional UNet (AttnDownBlock2D, AttnUpBlock2D, the mid block); one
  call reads q, k and v and writes o once, computes ``4 * B * heads * N^2 *
  d`` tensor FLOPs and ``B * heads * N^2`` exponentials.

A call's least time is the largest of its bytes at the memory rate, its
FLOPs at the peak and, for attention, its exponentials at the special
function unit's rate (``peaks``). The kernels' names, as the profiler
shows them, are the program's: ``KERNELS`` matches them.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from . import peaks

KERNELS = {"gn_silu": re.compile(r"\bgn_silu_(warp|cta)_kernel\b"),
           "flash_mha": re.compile(r"\bmha_(small|mma|simt)_kernel\b")}
ITEMSIZE = {"bfloat16": 2, "float32": 4}
GN_FLOPS_PER_ELEMENT = 8


def _levels(u: dict):
    """(level, kind, cin, cout) of every ResnetBlock2D and (level, attention kind, channels) of every
    attention block, in call order."""
    chs = u["block_out_channels"]
    n, lpb = len(chs), u.get("layers_per_block", 2)
    resnets, attns, skips, ch = [], [], [chs[0]], chs[0]
    for i, kind in enumerate(u["down_block_types"]):
        for _ in range(lpb):
            resnets.append((i, ch, chs[i]))
            if kind != "DownBlock2D":
                attns.append((i, kind, chs[i]))
            ch = chs[i]
            skips.append(ch)
        if i != n - 1:
            skips.append(ch)
    resnets += [(n - 1, ch, ch), (n - 1, ch, ch)]
    attns.append((n - 1, "CrossAttn" if u.get("cross_attention_dim") else "Attn", ch))
    for i, kind in enumerate(u["up_block_types"]):
        out = chs[::-1][i]
        for _ in range(lpb + 1):
            resnets.append((n - 1 - i, ch + skips.pop(), out))
            if kind != "UpBlock2D":
                attns.append((n - 1 - i, kind, out))
            ch = out
    return resnets, attns


def gn_silu_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(B, C, H, W) of each GroupNorm+SiLU kernel call of one UNet forward (none without ``fused_groupnorm``)."""
    if not cfg.get("fused_groupnorm"):
        return []
    u = cfg["unet"]
    h, w = u["sample_size"]
    calls = []
    for level, cin, cout in _levels(u)[0]:
        calls += [(batch, cin, h >> level, w >> level), (batch, cout, h >> level, w >> level)]
    return calls


def mha_calls(cfg: dict, batch: int) -> List[Tuple[int, int, int, int]]:
    """(B, heads, N, d) of each attention kernel call of one UNet forward."""
    u = cfg["unet"]
    h, w = u["sample_size"]
    hd = u.get("attention_head_dim", 8)
    return [(batch, max(c // hd, 1), (h >> level) * (w >> level), c // max(c // hd, 1))
            for level, kind, c in _levels(u)[1] if kind.startswith("Attn")]


def gn_silu_least_s(shape, dtype: str) -> float:
    b, c, h, w = shape
    n = b * c * h * w
    nbytes = 2 * n * ITEMSIZE[dtype] + 2 * c * 4
    return max(nbytes / peaks.HBM_BYTES_PER_S, GN_FLOPS_PER_ELEMENT * n / peaks.F32_FLOPS)


def mha_least_s(shape, dtype: str) -> float:
    b, h, n, d = shape
    nbytes = 4 * b * h * n * d * ITEMSIZE[dtype]
    tensor = 4 * b * h * n * n * d / (peaks.BF16_FLOPS if dtype == "bfloat16" else peaks.F32_FLOPS)
    return max(nbytes / peaks.HBM_BYTES_PER_S, tensor, b * h * n * n / peaks.EXP_PER_S)


LEAST = {"gn_silu": (gn_silu_calls, gn_silu_least_s), "flash_mha": (mha_calls, mha_least_s)}


def per_forward(kernel: str, cfg: dict, batch: int) -> Tuple[int, float]:
    """(calls, least seconds) of ``kernel`` in one UNet forward of ``batch`` rows."""
    calls, least = LEAST[kernel]
    shapes = calls(cfg, batch)
    return len(shapes), sum(least(s, cfg["dtype"]) for s in shapes)
