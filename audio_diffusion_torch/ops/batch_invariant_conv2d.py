"""Batch-invariant bf16 convolution for the serving window.

Inside the batcher's window (``utils/batch_invariant.py``) a row's result
must not depend on the batch around it, and cuDNN, which picks other kernels
for other batch sizes, is off. :class:`..models.unet2d.Conv2d` then sends
every bf16 convolution on the card to :func:`batch_invariant_conv2d`: ONE
launch of ``csrc/batch_invariant_conv2d.cu`` per call, an implicit GEMM over
the NCHW activations that reads the f32 weight and rounds it to bf16 as it
loads it (round to nearest even, bitwise ``weight.to(torch.bfloat16)``), sums
in f32, adds the bias rounded to bf16 and rounds the output once. It takes
kernel sizes 1 and 3, strides 1 and 2 and any padding: every convolution of
the UNets and VAEs.

How a call is tiled is the :class:`ConvPlan` of :func:`conv_plan`, a function
of (Cin, Cout, Ho, Wo, kh, kw, stride) only and never of the batch: the tile,
the split of K over a cluster and the order of every sum are the same at
every tier, so a row's bits are too. The wrapper counts its launches in
``.launches``. :func:`conv2d_plain` is the same function in plain PyTorch
(what ``Conv2d`` computes outside the window); the wrapper takes it only for
CPU tensors, and for any other launches the kernel or raises. The kernel has
no backward, so the wrapper refuses inputs that autograd would record.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from . import _build

SUB = 16  # kSub: input channels per mma k-step
STAGES = 3  # kStages: weight chunks in flight
MAX_SMEM = 227 * 1024  # kMaxSmem
MAX_SPLITS = 8  # CTAs of a cluster at most (the portable limit)
# Tiles, by csrc config id: (block_m, block_n, warps_m, warps_n, patch loads of 8 channels per thread and chunk).
TILES = {0: (256, 64, 8, 2, 4), 1: (64, 64, 2, 2, 8), 2: (32, 32, 2, 2, 8), 3: (128, 64, 4, 2, 8)}
# The K split is sized to put at least TARGET_CTAS CTAs on the card at NOMINAL_BATCH rows, the batcher's usual
# tier: a constant, so the split depends on the layer's shape alone.
NOMINAL_BATCH = 8
TARGET_CTAS = 128


# ----------------------------------------------------------------- plain torch

def conv2d_plain(x: torch.Tensor, weight: torch.Tensor, bias, stride=1, padding=0) -> torch.Tensor:
    """What ``Conv2d`` computes outside the window: the f32 parameters cast to
    x's dtype, then ``F.conv2d``."""
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), stride, padding)


# ----------------------------------------------------------------- launch plan

class _CPlan(ctypes.Structure):
    """The kernel's view of a plan: ``struct ConvPlan`` in csrc/batch_invariant_conv2d.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "config", "cin", "cout", "ho", "wo", "kh", "kw", "stride", "splits", "rows", "seg", "segs", "patch_w",
        "patch_pixels", "chunks", "smem")]


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How one layer's calls are tiled, whatever their batch.

    An M tile is ``rows`` whole output rows of ``seg`` = Wo pixels (Wo <
    block_m) or ``seg`` = block_m pixels of one row; its CTA stages the
    ``patch_pixels`` input pixels they read, ``rows * kh`` patch rows of
    ``patch_w``. ``splits`` CTAs of a cluster each sum a contiguous range of
    the ``chunks`` K chunks (16 input channels and every tap of a 3x3
    kernel, 64 of a 1x1 kernel), added in rank order.
    """

    config: int
    units: int
    block_m: int
    block_n: int
    threads: int
    splits: int
    rows: int
    seg: int
    patch_w: int
    patch_pixels: int
    chunks: int
    smem: int
    c_plan: _CPlan = dataclasses.field(repr=False, compare=False)
    c_address: int = dataclasses.field(repr=False, compare=False)


def _steps(taps: int) -> int:
    """Chunk<T>::kSteps: k-steps of 16 channels per K chunk."""
    return 4 if taps == 1 else 1


def _smem(block_m: int, block_n: int, taps: int, patch_pixels: int) -> int:
    """Layout<BM, BN, T>::smem: the weight staging slots (later the partial tile), two bf16 weight tiles, two
    patches."""
    steps = _steps(taps)
    region0 = max(STAGES * block_n * SUB * steps * taps * 4, block_n * (block_m + 4) * 4)
    return region0 + 2 * steps * taps * block_n * 32 + 2 * steps * patch_pixels * 32


def _make_plan(cin: int, cout: int, ho: int, wo: int, kh: int, kw: int, stride: int) -> ConvPlan:
    if (kh, kw) not in ((1, 1), (3, 3)) or stride not in (1, 2):
        raise ValueError(f"batch_invariant_conv2d takes 1x1 and 3x3 kernels at stride 1 or 2, got {kh}x{kw} "
                         f"stride {stride}")
    if min(cin, cout, ho, wo) < 1:
        raise ValueError(f"batch_invariant_conv2d: empty layer (cin {cin}, cout {cout}, output {ho}x{wo})")
    # Large levels are tensor-core work and take the large tiles (16 warps; 8 where the patch would not fit their
    # loads, as at stride 2, whose patch is twice as wide); below 32x32 the weights' bytes bound the call, and
    # narrower tiles with a K split spread them over more SMs.
    for config in ((0, 3) if ho * wo >= 1024 else (1,) if ho * wo >= 64 else (2,)):
        block_m, block_n, warps_m, warps_n, units = TILES[config]
        threads = 32 * warps_m * warps_n
        seg = min(wo, block_m)
        rows = block_m // seg
        patch_w = (seg - 1) * stride + kw
        patch_pixels = rows * kh * patch_w
        if 2 * _steps(kh * kw) * patch_pixels <= units * threads:
            break
    else:
        raise ValueError(f"batch_invariant_conv2d: a {patch_pixels}-pixel patch exceeds the kernel's loads")
    chunks = -(-cin // (SUB * _steps(kh * kw)))
    segs = -(-wo // seg)
    ctas = -(-NOMINAL_BATCH * ho // rows) * segs * -(-cout // block_n)
    splits = 1
    while splits < MAX_SPLITS and ctas * splits < TARGET_CTAS and 2 * splits <= chunks:
        splits *= 2
    smem = _smem(block_m, block_n, kh * kw, patch_pixels)
    if smem > MAX_SMEM:
        raise ValueError(f"batch_invariant_conv2d: {smem} bytes of shared memory exceed the card's {MAX_SMEM}")
    c_plan = _CPlan(config, cin, cout, ho, wo, kh, kw, stride, splits, rows, seg, segs, patch_w, patch_pixels,
                    chunks, smem)
    return ConvPlan(config, units, block_m, block_n, threads, splits, rows, seg, patch_w, patch_pixels, chunks, smem,
                    c_plan, ctypes.addressof(c_plan))


_PLANS: dict = {}


def conv_plan(cin: int, cout: int, ho: int, wo: int, kh: int, kw: int, stride: int) -> ConvPlan:
    """The kernel's plan for one layer shape, made once and kept. It takes no
    batch: every tier of a layer launches the same tiles."""
    key = (cin, cout, ho, wo, kh, kw, stride)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _make_plan(*key)
    return plan


def _pair(v, what: str) -> int:
    a, b = (v, v) if isinstance(v, int) else tuple(v)
    if a != b:
        raise ValueError(f"batch_invariant_conv2d: {what} must be the same along H and W, got {v}")
    return a


def out_size(n: int, k: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - k) // stride + 1


# ----------------------------------------------------------------- CUDA kernel

def batch_invariant_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride=1, padding=0) -> torch.Tensor:
    """The CUDA kernel, one launch. x: contiguous NCHW bf16 on the current
    CUDA device; weight: contiguous (Cout, Cin, k, k) f32, k 1 or 3; bias:
    (Cout,) f32 or None, on the same device; stride 1 or 2. Returns a new
    contiguous bf16 tensor. Never synchronizes, so a CUDA graph can capture
    it. A CPU tensor takes :func:`conv2d_plain` and launches nothing."""
    if x.is_cpu:
        return conv2d_plain(x, weight, bias, stride, padding)
    if not x.is_cuda:
        raise ValueError(f"batch_invariant_conv2d: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"batch_invariant_conv2d: x must be bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"batch_invariant_conv2d: expected a contiguous NCHW tensor, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        raise RuntimeError("batch_invariant_conv2d has no backward: call it under torch.no_grad() or "
                           "torch.inference_mode()")
    b, cin, h, w = x.shape
    if weight.dim() != 4 or weight.shape[1] != cin:
        raise ValueError(f"batch_invariant_conv2d: weight {tuple(weight.shape)} does not fit input {tuple(x.shape)}")
    cout, _, kh, kw = weight.shape
    dev = x.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"batch_invariant_conv2d: x is on cuda:{dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not (weight.dtype == torch.float32 and weight.is_contiguous() and weight.get_device() == dev):
        raise ValueError(f"batch_invariant_conv2d: weight must be a contiguous f32 tensor on cuda:{dev}")
    if bias is not None and not (bias.dtype == torch.float32 and bias.shape == (cout,) and bias.is_contiguous()
                                 and bias.get_device() == dev):
        raise ValueError(f"batch_invariant_conv2d: bias must be a contiguous f32 ({cout},) tensor on cuda:{dev}")
    s, p = _pair(stride, "stride"), _pair(padding, "padding")
    ho, wo = out_size(h, kh, s, p), out_size(w, kw, s, p)
    plan = _PLANS.get((cin, cout, ho, wo, kh, kw, s)) or conv_plan(cin, cout, ho, wo, kh, kw, s)
    y = torch.empty((b, cout, ho, wo), dtype=torch.bfloat16, device=x.device)
    if b == 0:
        return y
    code = _build.load().on(dev).adt_bi_conv2d(
        x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w, p,
        plan.c_address, torch._C._cuda_getCurrentRawStream(dev))  # the current stream, without a Stream object
    if code:
        _build.check(code, f"batch_invariant_conv2d ({plan})")
    batch_invariant_conv2d.launches += 1
    return y


batch_invariant_conv2d.launches = 0
