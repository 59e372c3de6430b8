"""Many-small-heads self-attention: the port of ``audio_diffusion_tpu/ops/pallas_attention.py``.

Layout (B, heads, N, d), softmax scale 1/sqrt(d), scores, max and sum in f32,
output in q's dtype. On the card :func:`flash_mha` launches ONE kernel of
``csrc/mha.cu`` per call (replaces ``_attn_kernel``). Any N works: the TPU
version's ``MAX_TOKENS``/``shapes_qualify`` VMEM limits do not apply, and
every CUDA call goes to the kernel, including the N=4 and N=1 levels of the
latent UNet.

Which kernel runs is the :class:`AttentionPlan` of :func:`attention_plan`, a
function of (N, d, dtype) only and never of B, so a row's result does not
depend on the batch around it:

* ``small``: N <= :data:`SMALL_MAX_N` and d <= 32 (the latent UNets' N=1, 4
  and 16): up to 4 lanes per query row, each folding in every 4th key, merged
  by shuffles; many heads per CTA, no shared memory.
* ``mma``: bf16, d = 8, larger N (the pixel UNets' N=256 and 1024): tensor
  cores for both products, K and V staged in shared memory, online softmax.
* ``simt``: everything else (f32 above the ``small`` threshold, bf16 with
  d != 8, d >= 64): exact f32 arithmetic on the CUDA cores.

:func:`flash_mha` takes views whose last dimension has stride 1 (the UNet's
projections transposed to (B, heads, N, d), uncopied) and returns a view of
a (B, N, heads, d) buffer. It refuses inputs that autograd would record:
the gradient path is :class:`FlashMHA`, whose forward is one :func:`flash_mha`
launch and whose backward recomputes :func:`attention_reference` and
differentiates it, as the JAX package's ``custom_vjp`` does
(pallas_attention.py:100-117). That backward is plain PyTorch, not a kernel,
because the reference's ``_bwd`` is plain jnp too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..utils.flag_window import FlagWindow
from . import _build

HEAD_DIMS = (8, 16, 32, 64, 128)  # the head dims csrc/mha.cu instantiates
DTYPES = (torch.float32, torch.bfloat16)
# Route constants; the csrc constants of the same meaning must agree.
SMALL_MAX_N = 16  # kSmallMaxN
SMALL_MAX_D = 32  # the small route's instances: d in (8, 16, 32)
SMALL_THREADS = 256  # kSmallThreads
SMALL_MAX_SPLIT = 4  # lanes per query row at most on the small route
MMA_RESIDENT_KEYS = 2048  # kResidentKeys: K and V of a whole head in shared memory up to here
MMA_CHUNK_KEYS = 1024  # kChunkKeys: streamed through two buffers above it
# Warps per CTA at N <= MMA_WARPS_SPLIT_N and above it (at most kMmaMaxThreads / 32):
# 4 are faster at the pixel-256 UNet's N=256, 8 at the pixel-512 UNet's N=1024
# (chip_smoke.py, [attn-sweep]).
MMA_WARPS = (4, 8)
MMA_WARPS_SPLIT_N = 512
MMA_KEY_BLOCK = 64  # kKeyBlock
_ROUTE_IDS = {"small": 0, "mma": 1, "simt": 2}
_LOG2E = 1.4426950408889634


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention, the counterpart of ``reference_attention`` and
    of the Pallas body: f32 scores, softmax and weighted sum, cast to q's dtype."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``reference_attention`` (pallas_attention.py:46-52) in its rounding
    order: f32 scores, the 1/sqrt(d) scale, f32 softmax, the probabilities
    cast to q's dtype before the product with v, the result in q's dtype.
    :class:`FlashMHA` differentiates this function, as the JAX ``_bwd`` does."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v).to(q.dtype)


# ----------------------------------------------------------------- launch plan

class _CPlan(ctypes.Structure):
    """The kernel's view of a plan: ``struct MhaPlan`` in csrc/mha.cu."""

    _fields_ = [*((name, ctypes.c_int) for name in ("route", "is_bf16", "n", "d", "threads", "log_split", "chunk",
                                                    "smem")),
                ("c", ctypes.c_float)]


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How one call spreads its heads over the card.

    route: "small", "mma" or "simt" (module docstring). threads: per CTA.
    chunk: keys of K and V staged in shared memory per pass on the mma route
    (the whole head rounded up to a 64-key block, or :data:`MMA_CHUNK_KEYS`
    when it does not fit); 0 elsewhere. smem: the mma route's dynamic shared
    memory in bytes. split: lanes per query row on the small route.
    """

    route: str
    n: int
    d: int
    threads: int
    split: int  # small route: lanes per query row (N rounded up to a power of two, at most 4), 1 elsewhere
    chunk: int
    smem: int
    pack: int  # values per 16-byte load
    c_plan: _CPlan = dataclasses.field(repr=False, compare=False)  # what the C entry point reads
    c_address: int = dataclasses.field(repr=False, compare=False)  # its address, passed at each launch


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _make_plan(n: int, d: int, dtype: torch.dtype) -> AttentionPlan:
    if dtype not in DTYPES:
        raise TypeError(f"flash_mha: dtype must be float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha: head dim {d} not in {HEAD_DIMS}")
    if not 1 <= n < 2**31:
        raise ValueError(f"flash_mha: sequence length {n} outside [1, 2**31)")
    chunk = smem = 0
    split = 1
    if n <= SMALL_MAX_N and d <= SMALL_MAX_D:
        route, threads, split = "small", SMALL_THREADS, min(SMALL_MAX_SPLIT, _next_pow2(n))
    elif dtype == torch.bfloat16 and d == 8:
        route = "mma"
        threads = 32 * min(MMA_WARPS[n > MMA_WARPS_SPLIT_N], -(-n // 16))
        padded = -(-n // MMA_KEY_BLOCK) * MMA_KEY_BLOCK
        chunk = padded if padded <= MMA_RESIDENT_KEYS else MMA_CHUNK_KEYS
        smem = (2 if chunk == padded else 4) * chunk * 16  # K and V rows of 16 bytes, one or two buffers
    else:
        route, threads = "simt", 32 if n <= 32 else (64 if n <= 64 else 128)
    c = 1.0 / math.sqrt(d) * _LOG2E
    c_plan = _CPlan(_ROUTE_IDS[route], int(dtype == torch.bfloat16), n, d, threads, split.bit_length() - 1, chunk,
                    smem, c)
    pack = 16 // (4 if dtype == torch.float32 else 2)
    return AttentionPlan(route, n, d, threads, split, chunk, smem, pack, c_plan, ctypes.addressof(c_plan))


_PLANS: dict = {}


def attention_plan(n: int, d: int, dtype: torch.dtype) -> AttentionPlan:
    """The kernel's launch plan for one (N, d, dtype), made once and kept."""
    key = (n, d, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _make_plan(*key)
    return plan


# ----------------------------------------------------------------- CUDA kernel

# The per-call values of adt_mha_fwd, filled in place: one ctypes argument
# instead of ten. The entry point holds the GIL (_build.GIL_HELD), so no other
# thread refills the array while the C side reads it.
_ARGS = (ctypes.c_longlong * 10)()
_ARGS_ADDRESS = ctypes.addressof(_ARGS)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel, one launch. q, k, v: (B, heads, N, d) tensors or views
    on the current CUDA device with one dtype (f32 or bf16), d in
    :data:`HEAD_DIMS`, the same strides, and stride 1 in the last dimension.
    Returns (B, heads, N, d), a view of a new (B, N, heads, d) buffer. Never
    synchronizes, so a CUDA graph can capture it."""
    if not q.is_cuda:
        raise ValueError(f"flash_mha: expected CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_mha: q, k, v must be (B, heads, N, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    st = q.stride()
    if st[3] != 1 or k.stride() != st or v.stride() != st:
        raise ValueError(f"flash_mha: q, k, v need one stride set with stride 1 in the last dimension, got "
                         f"{st}, {k.stride()}, {v.stride()}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha: q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_mha has no backward of its own: under autograd call FlashMHA.apply(q, k, v) "
                           "(or multi_head_attention), else torch.no_grad() or torch.inference_mode()")
    b, h, n, d = q.shape
    plan = _PLANS.get((n, d, q.dtype)) or attention_plan(n, d, q.dtype)
    dev = q.get_device()
    if not k.get_device() == v.get_device() == dev == torch.cuda.current_device():
        raise ValueError(f"flash_mha: q, k, v must lie on the current device cuda:{torch.cuda.current_device()}")
    o = torch.empty_strided((b, h, n, d), (n * h * d, d, h * d, 1), dtype=q.dtype, device=q.device)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    vec = int((qp | kp | vp) % 16 == 0 and (st[0] % plan.pack, st[1] % plan.pack, st[2] % plan.pack) == (0, 0, 0))
    _ARGS[:] = (qp, kp, vp, o.data_ptr(), b * h, h, st[0], st[1], st[2], vec)
    code = _build.load().on(dev).adt_mha_fwd(_ARGS_ADDRESS, plan.c_address,
                                     torch._C._cuda_getCurrentRawStream(dev))  # current stream, no Stream object
    if code:
        _build.check(code, f"flash_mha ({plan.route} route)")
    flash_mha.launches += 1
    return o


flash_mha.launches = 0


class FlashMHA(torch.autograd.Function):
    """The gradient path of :func:`flash_mha`, the port of its ``jax.custom_vjp``.

    ``FlashMHA.apply(q, k, v, forward=None)``: the forward is ``forward(q, k,
    v)``, :func:`flash_mha` (one launch) unless another callable is given (the
    CPU tests pass :func:`attention_plain`), and saves q, k and v. The
    backward recomputes :func:`attention_reference` from them and takes its
    vector-Jacobian product with ``torch.autograd.grad``: gradients of the
    inputs' shapes, in new tensors that alias nothing saved. ``backwards``
    counts backward calls as ``flash_mha.launches`` counts forwards."""

    backwards = 0

    @staticmethod
    def forward(ctx, q, k, v, forward=None):
        ctx.save_for_backward(q, k, v)
        return (forward or flash_mha)(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            grads = torch.autograd.grad(attention_reference(*leaves), leaves, grad)
        FlashMHA.backwards += 1
        return (*grads, None)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over layout (B, heads, N, d). CPU tensors
    take :func:`attention_plain`; CUDA tensors launch :func:`flash_mha`, through
    :class:`FlashMHA` when autograd records the call, or raise."""
    if q.is_cpu:
        return attention_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashMHA.apply(q, k, v)
    return flash_mha(q, k, v)


# ------------------------------------------- jax.nn.dot_product_attention's counterpart

def dot_product_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.dot_product_attention``'s XLA math (``_dot_product_attention_core``,
    jax 0.9) over layout (B, N, heads, d) for q and (B, M, heads, d) for k and
    v: f32 logits scaled by 1/sqrt(d), f32 softmax, probabilities cast to v's
    dtype before the product with v. Materialises the (B, heads, N, M) logits."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch's ``F.scaled_dot_product_attention`` over layout (B, N, heads, d)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


# torch's deterministic algorithms, strictly (an op that has both forms takes its deterministic one), held only while
# an :class:`SDPA` backward runs. The setting is one for the process; other threads see it meanwhile.
deterministic_algorithms = FlagWindow(
    lambda: (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()),
    lambda flags: torch.use_deterministic_algorithms(flags[0], warn_only=flags[1]), (True, False))


class SDPA(torch.autograd.Function):
    """The gradient path of :func:`dot_product_attention` on the card: a
    backward that repeats itself bitwise.

    ``SDPA.apply(q, k, v)``: the forward is :func:`_sdpa` and saves q, k and
    v. Left free, torch's attention backwards (cuDNN's, flash's, the
    memory-efficient one) sum the query gradient with atomics in a
    run-dependent order at the conditional UNet's self-attention shapes
    (N = 4,096 and 1,024; scripts/repeat_probe.py). The backward therefore
    recomputes :func:`_sdpa` from the saved inputs and takes its VJP inside
    :data:`deterministic_algorithms`, where torch dispatches to a backward
    with a fixed order (flash attention's deterministic one in bf16). No op
    there calls cuBLAS, whose own check asks for ``CUBLAS_WORKSPACE_CONFIG``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _sdpa(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), deterministic_algorithms():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(_sdpa(*leaves), leaves, grad)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The conditional UNet's ``CrossAttention`` core, (B, N, heads, d) queries
    over (B, M, heads, d) keys and values. In the JAX package it is XLA's
    ``jax.nn.dot_product_attention``, not a Pallas kernel, so the card runs
    torch's ``F.scaled_dot_product_attention`` (no logits in memory) and no
    kernel of this repo, through :class:`SDPA` when autograd records the
    call; CPU tensors take :func:`dot_product_attention_plain`."""
    if q.is_cpu:
        return dot_product_attention_plain(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return SDPA.apply(q, k, v)
    return _sdpa(q, k, v)
