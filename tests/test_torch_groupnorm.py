"""Port parity: audio_diffusion_torch.ops.fused_groupnorm (plain version, CPU)
against the JAX package's fused_group_norm_silu. At C % 128 == 0 the JAX side
runs the Pallas bodies in interpret mode; at C=32 it takes ``_reference``.
Also the kernel's launch plan, which is computed on the host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.models import unet2d
from audio_diffusion_torch.models.unet2d import ResnetBlock2D, UNet2D, unconditional_config
from audio_diffusion_torch.ops import attention as at
from audio_diffusion_torch.ops import fused_groupnorm as gn
from audio_diffusion_tpu.ops.pallas_groupnorm import fused_group_norm_silu as jax_fused


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 128), 32), ((1, 8, 8, 256), 32), ((2, 8, 8, 32), 4)])
def test_plain_matches_jax(shape, groups, eps):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, eps,
                                interpret=True))
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = gn.fused_group_norm_silu(x_nchw, torch.from_numpy(scale), torch.from_numpy(bias), groups, eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5)


def norm_shapes(sample_size, monkeypatch):
    """(C, H, W) of every GroupNorm+SiLU call of a ResnetBlock2D in one forward
    of the full-width unconditional UNet, traced on the meta device (where
    attention takes its plain version)."""
    monkeypatch.setattr(unet2d, "multi_head_attention", at.attention_plain)
    cfg = unconditional_config(sample_size=sample_size)
    with torch.device("meta"):
        unet = UNet2D(cfg)
    calls = []

    def hook(mod, args):
        _, c, h, w = args[0].shape
        calls.extend([(c, h, w), (mod.norm2.num_channels, h, w)])

    for m in unet.modules():
        if isinstance(m, ResnetBlock2D):
            m.register_forward_pre_hook(hook)
    h, w = cfg.sample_hw()
    unet(torch.zeros(1, h, w, cfg.in_channels, device="meta"), torch.zeros(1, dtype=torch.long, device="meta"))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latent256_calls_take_one_pass_routes(dtype, monkeypatch):
    """All 64 calls of a latent-256 UNet forward read x once: warp or block route."""
    calls = norm_shapes((32, 32), monkeypatch)
    assert len(calls) == 64
    routes = [gn.launch_plan(c, h, w, 32, dtype).route for c, h, w in calls]
    assert set(routes) == {"warp", "block"}
    assert max(c // 32 * h * w for c, h, w in calls) == 8192  # the largest slab fits one CTA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel256_slab_takes_a_cluster(dtype, monkeypatch):
    """Every slab of the pixel-256 UNet stays on chip; those above one CTA's
    share, up to (256, 256, 256) with 524,288 values, take a cluster."""
    calls = norm_shapes((256, 256), monkeypatch)
    assert (128, 256, 256) in calls and (256, 256, 256) in calls
    for c, h, w in calls:
        plan = gn.launch_plan(c, h, w, 32, dtype)
        assert plan.route == "cluster" if plan.slab > gn.BLOCK_MAX_SLAB else plan.route in ("warp", "block")
    plan = gn.launch_plan(128, 256, 256, 32, dtype)
    assert plan.route == "cluster" and plan.ctas == gn.MAX_CLUSTER and plan.smem > 0


@pytest.mark.parametrize("dtype,route", [(torch.float32, "reread"), (torch.bfloat16, "cluster")])
def test_pixel512_slab(dtype, route):
    """4 x 512 x 512 values per slab: a 16-CTA cluster holds it in bf16 only;
    in f32 each CTA reads its chunk twice."""
    assert gn.launch_plan(128, 512, 512, 32, dtype).route == route


def test_plan_depends_only_on_shape_and_dtype():
    """No batch size enters the plan, and a plan is made once per key."""
    a = gn.launch_plan(256, 32, 32, 32, torch.bfloat16)
    assert gn.launch_plan(256, 32, 32, 32, torch.bfloat16) is a
    assert gn._make_plan(256, 32, 32, 32, torch.bfloat16) == a
    assert gn.launch_plan(256, 32, 32, 32, torch.float32) != a  # the pack width differs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w,groups", [(96, 5, 7, 32), (64, 33, 33, 32), (512, 1, 1, 32), (1024, 2, 2, 32),
                                          (128, 32, 32, 32), (256, 32, 32, 32), (128, 128, 128, 32),
                                          (8, 1000, 1001, 4), (32, 512, 512, 4), (3, 4099, 4099, 1)])
def test_plan_covers_every_value_of_the_slab(c, h, w, groups, dtype):
    p = gn.launch_plan(c, h, w, groups, dtype)
    size = torch.finfo(dtype).bits // 8
    assert p.slab == c // groups * h * w and p.pack * size == 16
    if p.route == "warp":
        assert p.slab <= gn.WARP_MAX_SLAB and p.ctas == 0 and p.smem == 0
        return
    assert p.chunk % p.pack == 0
    assert p.ctas * p.chunk >= p.slab > (p.ctas - 1) * p.chunk  # every CTA has values, none is left over
    assert 1 <= p.ctas <= gn.MAX_CLUSTER and p.ctas & (p.ctas - 1) == 0
    assert p.threads % 32 == 0 and 64 <= p.threads <= gn.MAX_THREADS
    assert p.smem == (p.chunk * size if p.route != "reread" else 0) <= gn.MAX_CACHE_BYTES
    assert (p.route == "block") == (p.ctas == 1)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gn.launch_plan(64, 4, 4, 32, torch.float16)
    with pytest.raises(ValueError, match="divisible"):
        gn.launch_plan(60, 4, 4, 32, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        gn.launch_plan(32, 2**16, 2**16, 1, torch.float32)
