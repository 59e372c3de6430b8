"""Fused GroupNorm + SiLU: the port of ``audio_diffusion_tpu/ops/pallas_groupnorm.py``.

Tensors are NCHW and contiguous, so the values of one (batch, group) pair
form one contiguous slab of ``C/G * H * W`` elements. Two CUDA kernels
(``csrc/group_norm_silu.cu``) do the work on the card:

* :func:`group_norm_stats` (replaces ``_stats_kernel``): per-(batch, group)
  partial sums of x and x^2 in f32, one block per (slab, split), written to a
  ``(B*G, splits, 2)`` scratch without atomics;
* :func:`group_norm_silu_apply` (replaces ``_apply_kernel``): finishes mean
  and rstd from the partials (fast variance ``E[x^2] - mean^2``) and writes
  ``silu((x - mean) * rstd * scale + bias)`` in x's dtype.

``splits`` depends only on (C, H, W, G), never on B, so a row's result does
not depend on the batch around it. Each wrapper counts its launches in
``.launches``. The plain PyTorch versions below are the same function; the
dispatcher :func:`fused_group_norm_silu` takes them only for CPU tensors.
Neither kernel has a backward yet, so the CUDA wrappers refuse inputs that
autograd would record.
"""

from __future__ import annotations

import torch

from . import _build

# One split per this many slab elements, at most MAX_SPLITS. At the latent-256
# shapes a slab holds 32 (C=1024 at 1x1) to 4096 (C=128 at 32x32) values.
SPLIT_ELEMS = 1024
MAX_SPLITS = 32


def num_splits(channels: int, height: int, width: int, groups: int) -> int:
    """Chunks per (batch, group) slab: a function of the slab size only."""
    slab = channels // groups * height * width
    return max(1, min(MAX_SPLITS, slab // SPLIT_ELEMS))


# ----------------------------------------------------------------- plain torch

def group_norm_stats_plain(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*G, 2) f32 [sum x, sum x^2] per (batch, group)."""
    xf = x.float().reshape(x.shape[0] * groups, -1)
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=-1)


def group_norm_silu_apply_plain(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """Normalize with (B*G, 2) sums, then affine and SiLU; output in x's dtype."""
    b, c, h, w = x.shape
    count = c // groups * h * w
    mean = sums[:, 0] / count
    var = sums[:, 1] / count - mean * mean
    rstd = torch.rsqrt(var + eps)
    xf = x.float().reshape(b * groups, -1)
    y = ((xf - mean[:, None]) * rstd[:, None]).reshape(b, c, h, w)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch GroupNorm+SiLU (f32 statistics, fast variance), the
    counterpart of ``pallas_groupnorm._reference``. x is NCHW."""
    return group_norm_silu_apply_plain(x, group_norm_stats_plain(x, groups), scale, bias, groups, eps)


# ---------------------------------------------------------------- CUDA kernels

def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous NCHW tensor, got shape {tuple(x.shape)}")


def _no_grad(what: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward yet (ROADMAP Queue 2); "
                           "call it under torch.no_grad() or torch.inference_mode()")


def _slab(x: torch.Tensor, groups: int) -> int:
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"channels ({c}) must be divisible by groups ({groups})")
    slab = c // groups * h * w
    if slab >= 2**31:
        raise ValueError(f"group slab of {slab} elements exceeds the kernel's int32 indexing")
    return slab


def group_norm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """CUDA stats kernel. x: contiguous NCHW, f32 or bf16, on the card.
    Returns the (B*G, splits, 2) f32 partial sums."""
    _check_cuda(x, "group_norm_stats")
    _no_grad("group_norm_stats", x)
    b, c, h, w = x.shape
    slab = _slab(x, groups)
    splits = num_splits(c, h, w, groups)
    partials = torch.empty((b * groups, splits, 2), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.adt_group_norm_stats(x.data_ptr(), partials.data_ptr(), int(x.dtype == torch.bfloat16),
                                        b * groups, slab, splits, stream)
    _build.check(code, "group_norm_stats")
    group_norm_stats.launches += 1
    return partials


group_norm_stats.launches = 0


def group_norm_silu_apply(x: torch.Tensor, partials: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """CUDA apply kernel. x: contiguous NCHW on the card; partials from
    :func:`group_norm_stats`; scale and bias (C,) f32. Output like x."""
    _check_cuda(x, "group_norm_silu_apply")
    _no_grad("group_norm_silu_apply", x, scale, bias)
    b, c, h, w = x.shape
    _slab(x, groups)
    splits = num_splits(c, h, w, groups)
    if partials.shape != (b * groups, splits, 2) or partials.dtype != torch.float32 \
            or partials.device != x.device or not partials.is_contiguous():
        raise ValueError(f"partials must be contiguous f32 ({b * groups}, {splits}, 2) on {x.device}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.shape != (c,) or p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 ({c},) tensor on {x.device}")
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.adt_group_norm_silu_apply(
            x.data_ptr(), partials.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16), b * groups, groups, c // groups, h * w, splits, float(eps), stream)
    _build.check(code, "group_norm_silu_apply")
    group_norm_silu_apply.launches += 1
    return y


group_norm_silu_apply.launches = 0


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm (over H, W and the group's channels) followed by SiLU.

    Args:
        x: (B, C, H, W) NCHW activations, f32 or bf16.
        scale, bias: (C,) f32 affine parameters.
    Returns:
        same shape and dtype as ``x``.

    A CPU tensor takes :func:`group_norm_silu_plain`; a CUDA tensor launches
    the two kernels or raises.
    """
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps)
    partials = group_norm_stats(x, groups)
    return group_norm_silu_apply(x, partials, scale, bias, groups, eps)
