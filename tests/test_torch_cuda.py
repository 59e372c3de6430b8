"""Kernel-wrapper contracts of the port. This file imports no JAX, so the
GPU-marked tests run on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card those tests skip; the CPU dispatch tests run everywhere."""

import pytest
import torch

from audio_diffusion_torch.ops import attention as at
from audio_diffusion_torch.ops import fused_groupnorm as gn


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def test_cpu_tensors_take_the_plain_version_and_never_count():
    before = (gn.group_norm_stats.launches, gn.group_norm_silu_apply.launches, at.flash_mha.launches)
    x = torch.randn(2, 64, 4, 4)
    w = torch.ones(64)
    torch.testing.assert_close(gn.fused_group_norm_silu(x, w, w, 32, 1e-5),
                               gn.group_norm_silu_plain(x, w, w, 32, 1e-5), rtol=0, atol=0)
    q = torch.randn(1, 64, 4, 8)
    torch.testing.assert_close(at.multi_head_attention(q, q, q), at.attention_plain(q, q, q), rtol=0, atol=0)
    assert (gn.group_norm_stats.launches, gn.group_norm_silu_apply.launches, at.flash_mha.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 64, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_stats(x, 32)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_silu_apply(x, torch.zeros(64, 1, 2), torch.ones(64), torch.ones(64), 32, 1e-5)
    q = torch.randn(1, 64, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_mha(q, q, q)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_requires_grad():
    _cuda()
    x = torch.randn(2, 64, 4, 4, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        gn.fused_group_norm_silu(x, w, torch.zeros_like(w), 32, 1e-5)
    q = torch.randn(1, 64, 4, 8, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        at.multi_head_attention(q, q, q)
    with torch.no_grad():
        assert gn.fused_group_norm_silu(x, w, torch.zeros_like(w), 32, 1e-5).shape == x.shape
        assert at.multi_head_attention(q, q, q).shape == q.shape


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_cannot_take():
    _cuda()
    x = torch.randn(2, 64, 4, 4, device="cuda")
    with pytest.raises(TypeError):
        gn.group_norm_stats(x.half(), 32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_stats(x.transpose(2, 3), 32)
    q = torch.randn(1, 4, 16, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        at.flash_mha(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_and_rows_do_not_depend_on_the_batch(dtype):
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 256, 16, 16, generator=g, device="cuda").to(dtype)
    w, b = torch.randn(256, generator=g, device="cuda"), torch.randn(256, generator=g, device="cuda")
    y = gn.fused_group_norm_silu(x, w, b, 32, 1e-5)
    ref = gn.group_norm_silu_plain(x, w, b, 32, 1e-5)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol * ref.float().abs().max().item())
    torch.testing.assert_close(gn.fused_group_norm_silu(x[:1].contiguous(), w, b, 32, 1e-5), y[:1], rtol=0, atol=0)
    q, k, v = (torch.randn(2, 64, 256, 8, generator=g, device="cuda").to(dtype) for _ in range(3))
    o = at.multi_head_attention(q, k, v)
    torch.testing.assert_close(o.float(), at.attention_plain(q.float(), k.float(), v.float()), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 1e-2)
    torch.testing.assert_close(at.multi_head_attention(q[:1].contiguous(), k[:1].contiguous(),
                                                       v[:1].contiguous()), o[:1], rtol=0, atol=0)
