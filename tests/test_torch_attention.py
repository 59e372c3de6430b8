"""Port parity: audio_diffusion_torch.ops.attention (plain version, CPU)
against the JAX Pallas attention body in interpret mode and against
``reference_attention`` at the latent UNet's N=1 and N=4, h=64, d=8, on
contiguous inputs and on the strided views the UNet passes; the kernel's
launch plan and the bound that chip_smoke.py holds it to."""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.ops import attention as at
from audio_diffusion_tpu.ops.pallas_attention import _flash_mha_fwd, reference_attention


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 8, 64, 8), (1, 64, 256, 8), (2, 4, 128, 32), (1, 2, 64, 128)])
def test_plain_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, 0)
    want = np.asarray(_flash_mha_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = at.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [1, 4])
def test_plain_matches_reference_at_latent_shapes(n):
    q, k, v = _qkv((2, 64, n, 8), n)
    want = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = at.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _chip_smoke():
    """chip_smoke.py as a module: it imports torch only inside its functions."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(2, 8, 64, 8), (1, 64, 256, 8), (2, 4, 17, 32), (1, 64, 4, 8), (2, 2, 33, 128)])
def test_transposed_views_match_reference_and_pallas_interpret(shape):
    """The UNet hands over its (B, N, heads, d) projections transposed to
    (B, heads, N, d), uncopied."""
    b, h, n, d = shape
    q, k, v = _qkv((b, n, h, d), 7)
    views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = at.multi_head_attention(*views).numpy()
    qj, kj, vj = (jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3))) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(reference_attention(qj, kj, vj)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_flash_mha_fwd(qj, kj, vj, interpret=True)), atol=1e-5)


def test_attention_plan_depends_on_n_d_and_dtype_only():
    plan = at.attention_plan(256, 8, torch.bfloat16)
    assert at.attention_plan(256, 8, torch.bfloat16) is plan  # made once per key, kept
    assert plan == at._make_plan(256, 8, torch.bfloat16)
    params = inspect.signature(at.attention_plan).parameters
    assert list(params) == ["n", "d", "dtype"]


@pytest.mark.parametrize("n, d, dtype, route", [
    (1, 8, torch.bfloat16, "small"), (4, 8, torch.bfloat16, "small"), (1, 8, torch.float32, "small"),
    (4, 8, torch.float32, "small"), (16, 8, torch.bfloat16, "small"), (4, 32, torch.float32, "small"),
    (17, 8, torch.bfloat16, "mma"), (256, 8, torch.bfloat16, "mma"), (1024, 8, torch.bfloat16, "mma"),
    (5000, 8, torch.bfloat16, "mma"),
    (17, 8, torch.float32, "simt"), (256, 8, torch.float32, "simt"), (1024, 8, torch.float32, "simt"),
    (256, 32, torch.bfloat16, "simt"), (4, 64, torch.bfloat16, "simt"), (4, 128, torch.float32, "simt"),
])
def test_attention_plan_routes(n, d, dtype, route):
    plan = at.attention_plan(n, d, dtype)
    assert plan.route == route
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert (plan.c_plan.route, plan.c_plan.n, plan.c_plan.d) == (at._ROUTE_IDS[route], n, d)
    if route == "mma":
        # K and V rows of 16 bytes: the whole head (one buffer) or streamed chunks (two buffers)
        assert plan.chunk % at.MMA_KEY_BLOCK == 0 and plan.chunk >= min(n, at.MMA_CHUNK_KEYS)
        resident = plan.chunk >= n
        assert resident == (n <= at.MMA_RESIDENT_KEYS)
        assert plan.smem == (2 if resident else 4) * plan.chunk * 16 <= 64 * 1024
        assert plan.threads == 32 * min(at.MMA_WARPS[n > at.MMA_WARPS_SPLIT_N], -(-n // 16))
    else:
        assert plan.chunk == plan.smem == 0
    if route == "small":
        # N rounded up to a power of two, at most 4 lanes per row, all inside one warp
        assert plan.split == min(at.SMALL_MAX_SPLIT, 1 << (n - 1).bit_length())
        assert plan.split & (plan.split - 1) == 0 and 32 % plan.split == 0
        assert 1 << plan.c_plan.log_split == plan.split
    else:
        assert plan.split == 1


def test_attention_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="head dim"):
        at.attention_plan(4, 24, torch.float32)
    with pytest.raises(TypeError):
        at.attention_plan(4, 8, torch.float16)
    with pytest.raises(ValueError):
        at.attention_plan(0, 8, torch.float32)


@pytest.mark.parametrize("shape, itemsize, bound_by", [
    ((32, 64, 1024, 8), 2, "exp"), ((32, 64, 256, 8), 2, "exp"), ((32, 64, 4, 8), 2, "bytes"),
    ((32, 64, 1, 8), 2, "bytes"), ((32, 64, 1024, 8), 4, "tensor"), ((1, 1, 1024, 128), 2, "tensor")])
def test_attention_bound_counts_the_exponentials(shape, itemsize, bound_by):
    cs = _chip_smoke()
    ms, by = cs.attn_bound(shape, itemsize)
    assert by == bound_by
    b, h, n, d = shape
    exp_ms = b * h * n * n / (16 * 132 * 1.98e9) * 1e3
    assert ms >= exp_ms and ms >= 4 * b * h * n * d * itemsize / 3.35e12 * 1e3
    if shape == (32, 64, 1024, 8) and itemsize == 2:
        assert ms == pytest.approx(0.5135, rel=1e-3)  # 2.15e9 exponentials at 16 x 132 x 1.98 GHz
