"""Many-small-heads self-attention: the port of ``audio_diffusion_tpu/ops/pallas_attention.py``.

Layout (B, heads, N, d), softmax scale 1/sqrt(d), scores and softmax in f32,
output in q's dtype. On the card :func:`flash_mha` launches the CUDA kernel
of ``csrc/mha.cu`` (replaces ``_attn_kernel``), which streams keys and values
through shared memory with an online softmax, so any N works: the TPU
version's ``MAX_TOKENS``/``shapes_qualify`` VMEM limits do not apply, and
every CUDA call goes to the kernel, including the N=4 and N=1 levels of the
latent UNet. The kernel has no backward yet, so it refuses inputs that
autograd would record.
"""

from __future__ import annotations

import math

import torch

from . import _build

HEAD_DIMS = (8, 16, 32, 64, 128)  # template instances in csrc/mha.cu


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention, the counterpart of ``reference_attention`` and
    of the Pallas body: f32 scores, softmax and weighted sum, cast to q's dtype."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """CUDA attention kernel. q, k, v: contiguous (B, heads, N, d) tensors on
    the card, one dtype (f32 or bf16), d in :data:`HEAD_DIMS`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_mha: {name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"flash_mha: q, k, v must share dtype float32 or bfloat16, got {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_mha: {name} must be a contiguous (B, heads, N, d) tensor like q, "
                             f"got {tuple(t.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_mha has no backward yet (ROADMAP Queue 2); "
                           "call it under torch.no_grad() or torch.inference_mode()")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha: head dim {d} not in {HEAD_DIMS}")
    o = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.adt_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               int(q.dtype == torch.bfloat16), b * h, n, d, 1.0 / math.sqrt(d), stream)
    _build.check(code, "flash_mha")
    flash_mha.launches += 1
    return o


flash_mha.launches = 0


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over layout (B, heads, N, d). CPU tensors
    take :func:`attention_plain`; CUDA tensors launch :func:`flash_mha` or raise."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return flash_mha(q, k, v)
