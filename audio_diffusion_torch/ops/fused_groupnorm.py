"""Fused GroupNorm + SiLU: the port of ``audio_diffusion_tpu/ops/pallas_groupnorm.py``.

Tensors are NCHW and contiguous, so the values of one (batch, group) pair
form one contiguous slab of ``C/G * H * W`` elements. On the card
:func:`group_norm_silu` launches ONE kernel per call (``csrc/group_norm_silu.cu``,
replacing both ``_stats_kernel`` and ``_apply_kernel``): it reads each slab
once, keeps it on chip, takes f32 sums of x and x^2 (fast variance
``E[x^2] - mean^2``), and writes ``silu((x - mean) * rstd * scale + bias)`` in
x's dtype, rounded once.

How a slab is spread over the card is the :class:`LaunchPlan` of
:func:`launch_plan`, a function of (C, H, W, G, dtype) only and never of B,
so a row's result does not depend on the batch around it. The wrapper counts
its launches in ``.launches``. :func:`group_norm_silu_plain` is the same
function in plain PyTorch; the dispatcher :func:`fused_group_norm_silu` takes
it only for CPU tensors. The kernel has no backward (nor has the Pallas
kernel: the JAX trainer builds its UNets with ``fused_groupnorm=False``), so
the wrapper refuses inputs that autograd would record.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

# Routes by slab size (values per (batch, group)); the csrc constants of the
# same names must agree.
WARP_MAX_SLAB = 256  # kWarpSlab: one warp per slab, the slab in registers
BLOCK_MAX_SLAB = 16384  # one CTA per slab, the slab in shared memory
CLUSTER_CHUNK = 16384  # values per CTA that a cluster is sized for
MAX_CLUSTER = 16  # CTAs per slab at most (non-portable above 8)
MAX_CACHE_BYTES = 200 * 1024  # kMaxSmem: a CTA's chunk above this is read twice
MAX_THREADS = 512  # kCtaMaxThreads
DTYPES = (torch.float32, torch.bfloat16)


# ----------------------------------------------------------------- plain torch

def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch GroupNorm+SiLU (f32 statistics, fast variance), the
    counterpart of ``pallas_groupnorm._reference``. x is NCHW."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b * groups, -1)
    count = c // groups * h * w
    mean = xf.sum(-1) / count
    var = (xf * xf).sum(-1) / count - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[:, None]) * rstd[:, None]).reshape(b, c, h, w)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# ----------------------------------------------------------------- launch plan

class _CPlan(ctypes.Structure):
    """The kernel's view of a plan: ``struct GnPlan`` in csrc/group_norm_silu.cu."""

    _fields_ = [(name, ctypes.c_int) for name in ("is_bf16", "groups", "cs", "hw", "ctas", "chunk", "threads",
                                                  "smem")]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call spreads its slabs over the card.

    route: "warp" (one warp per slab, 8 slabs per block, registers), "block"
    (one CTA per slab, shared memory), "cluster" (a cluster of ``ctas`` CTAs
    per slab, each caching its chunk in shared memory, sums exchanged through
    distributed shared memory) or "reread" (as cluster, but the chunk is too
    large for shared memory and is read twice).
    """

    route: str
    slab: int  # values per (batch, group)
    ctas: int  # CTAs per slab: 0 on the warp route
    chunk: int  # values per CTA (a whole number of 16-byte packs)
    threads: int  # threads per CTA
    smem: int  # dynamic shared memory bytes: 0 on the warp and reread routes
    pack: int  # values per 16-byte load
    c_plan: _CPlan = dataclasses.field(repr=False, compare=False)  # what the C entry point reads
    c_address: int = dataclasses.field(repr=False, compare=False)  # its address, passed at each launch


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _make_plan(channels: int, height: int, width: int, groups: int, dtype: torch.dtype) -> LaunchPlan:
    if dtype not in DTYPES:
        raise TypeError(f"group_norm_silu: dtype must be float32 or bfloat16, got {dtype}")
    if groups <= 0 or channels % groups:
        raise ValueError(f"channels ({channels}) must be divisible by groups ({groups})")
    slab = channels // groups * height * width
    if slab >= 2**31:
        raise ValueError(f"group slab of {slab} elements exceeds the kernel's int32 indexing")
    size = 4 if dtype == torch.float32 else 2
    pack = 16 // size
    if slab <= WARP_MAX_SLAB:
        route, ctas, chunk, threads, smem = "warp", 0, slab, 32, 0
    else:
        ctas = 1
        if slab > BLOCK_MAX_SLAB:
            ctas = 2
            while ctas < MAX_CLUSTER and -(-slab // ctas) > CLUSTER_CHUNK:
                ctas *= 2
        chunk = -(-slab // ctas)
        chunk = -(-chunk // pack) * pack
        # About 4 packs a thread: a latent-256 call's CTAs then all fit on the card at once.
        threads = min(MAX_THREADS, max(64, _next_pow2(-(-chunk // (4 * pack)))))
        smem = chunk * size
        route = "block" if ctas == 1 else "cluster"
        if smem > MAX_CACHE_BYTES:
            route, smem = "reread", 0
    c_plan = _CPlan(int(dtype == torch.bfloat16), groups, channels // groups, height * width, ctas, chunk, threads,
                    smem)
    return LaunchPlan(route, slab, ctas, chunk, threads, smem, pack, c_plan, ctypes.addressof(c_plan))


_PLANS: dict = {}


def launch_plan(channels: int, height: int, width: int, groups: int, dtype: torch.dtype) -> LaunchPlan:
    """The kernel's launch plan for one (C, H, W, G, dtype), made once and kept."""
    key = (channels, height, width, groups, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _make_plan(*key)
    return plan


# ----------------------------------------------------------------- CUDA kernel

def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """The CUDA kernel, one launch. x: contiguous NCHW, f32 or bf16, on the
    current CUDA device; scale and bias: contiguous (C,) f32 on the same
    device. Returns a new tensor like x. Never synchronizes, so a CUDA graph
    can capture it."""
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu: expected a CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"group_norm_silu: expected a contiguous NCHW tensor, got shape {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        raise RuntimeError("group_norm_silu has no backward: train with fused_groupnorm=False (as the trainer "
                           "does), or call it under torch.no_grad() or torch.inference_mode()")
    b, c, h, w = x.shape
    plan = launch_plan(c, h, w, groups, x.dtype)
    dev = x.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"group_norm_silu: x is on cuda:{dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if not (scale.dtype == bias.dtype == torch.float32 and scale.shape == bias.shape == (c,)
            and scale.get_device() == bias.get_device() == dev and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"scale and bias must be contiguous f32 ({c},) tensors on cuda:{dev}")
    y = torch.empty_like(x)
    ptr = x.data_ptr()
    vec = int(ptr % 16 == 0 and plan.slab % plan.pack == 0)  # y is a fresh, aligned allocation
    code = _build.load().on(dev).adt_group_norm_silu(
        ptr, scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b * groups, eps, vec, plan.c_address,
        torch._C._cuda_getCurrentRawStream(dev))  # the handle of torch.cuda.current_stream(), without a Stream object
    if code:
        _build.check(code, f"group_norm_silu ({plan.route} route)")
    group_norm_silu.launches += 1
    return y


group_norm_silu.launches = 0


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm (over H, W and the group's channels) followed by SiLU.

    Args:
        x: (B, C, H, W) NCHW activations, f32 or bf16.
        scale, bias: (C,) f32 affine parameters.
    Returns:
        same shape and dtype as ``x``.

    A CPU tensor takes :func:`group_norm_silu_plain`; any other launches the
    kernel or raises.
    """
    if x.is_cpu:
        return group_norm_silu_plain(x, scale, bias, groups, eps)
    return group_norm_silu(x, scale, bias, groups, eps)
