"""The batch-invariant convolution's CPU contracts: the plain version on CPU
tensors, the tile plan's independence of the batch for every convolution of
the benchmarked configurations, and ``Conv2d``'s routing to the kernel only
for bf16 on the card inside the batcher's window. This file imports no JAX:
``test_torch_cuda.py`` takes :func:`conv_layers` from it."""

import contextlib
import inspect
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from audio_diffusion_torch.models import AutoencoderKL, UNet2D, VAEConfig, unet2d
from audio_diffusion_torch.models.unet2d import Conv2d, conditional_config, unconditional_config
from audio_diffusion_torch.ops import attention
from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
from audio_diffusion_torch.utils import batch_invariant

CONFIGS = ("latent-256", "cond-latent-512")
TIERS = (1, 2, 4, 8, 16, 32)


def conv_layers(config: str, batch: int) -> list:
    """Every convolution a batch of ``batch`` rows of ``config`` runs in the
    serving window (UNet forward, VAE decode, and VAE encode for
    audio-to-audio), found with pre-hooks on meta tensors: (x shape, weight
    shape, stride, padding, x dtype, the module's class name) per call."""
    cond = config == "cond-latent-512"
    res = 512 if cond else 256
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig(sample_size=res, dtype="bfloat16"))
        hw = vae.config.latent_hw(res, res)
        unet = UNet2D(conditional_config(hw, cross_attention_dim=100, dtype="bfloat16") if cond
                      else unconditional_config(hw, dtype="bfloat16"))
    seen = []

    def hook(mod, args):
        seen.append((tuple(args[0].shape), tuple(mod.weight.shape), mod.stride[0], mod.padding[0], args[0].dtype,
                     type(mod).__name__))

    hooks = [m.register_forward_pre_hook(hook) for model in (unet, vae) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    z = torch.zeros(batch, *hw, 1, device="meta")
    context = torch.zeros(batch, 1, 100, device="meta") if cond else None
    try:  # the attention kernel's wrapper takes no meta tensors; its plain version does
        with torch.inference_mode(), mock.patch.object(unet2d, "multi_head_attention", attention.attention_plain):
            unet(z, torch.tensor(5, device="meta"), context)
            vae.decode(z)
            vae.encode(torch.zeros(batch, res, res, 1, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return seen


def layer_plan(x_shape, w_shape, stride, padding) -> bic.ConvPlan:
    _, cin, h, w = x_shape
    cout, _, kh, kw = w_shape
    return bic.conv_plan(cin, cout, bic.out_size(h, kh, stride, padding), bic.out_size(w, kw, stride, padding), kh,
                         kw, stride)


@pytest.mark.parametrize("stride, padding, k", [(1, 1, 3), (2, 0, 3), (1, 0, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_version_with_the_rounded_weight(stride, padding, k, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 9, 7, generator=g).to(dtype)
    w, b = torch.randn(6, 5, k, k, generator=g), torch.randn(6, generator=g)
    before = bic.batch_invariant_conv2d.launches
    y = bic.batch_invariant_conv2d(x, w, b, stride, padding)
    torch.testing.assert_close(y, F.conv2d(x, w.to(dtype), b.to(dtype), stride, padding), rtol=0, atol=0)
    assert y.dtype == dtype and bic.batch_invariant_conv2d.launches == before


def test_the_kernel_wrapper_refuses_tensors_neither_on_the_cpu_nor_on_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        bic.batch_invariant_conv2d(torch.zeros(1, 4, 4, 4, device="meta", dtype=torch.bfloat16),
                                   torch.zeros(4, 4, 3, 3, device="meta"), None)


def test_the_tile_plan_takes_no_batch():
    assert list(inspect.signature(bic.conv_plan).parameters) == ["cin", "cout", "ho", "wo", "kh", "kw", "stride"]


@pytest.mark.parametrize("config", CONFIGS)
def test_every_served_conv_has_one_plan_at_every_tier(config):
    """Every bf16 convolution of the configuration, at each serving tier, has
    a plan the kernel takes, and a layer's plan is the same at every tier."""
    plans = {}
    for tier in TIERS:
        layers = [(x, w, s, p) for x, w, s, p, dtype, _ in conv_layers(config, tier) if dtype == torch.bfloat16]
        assert layers and all(x[0] == tier for x, *_ in layers)
        plans[tier] = [layer_plan(x, w, s, p) for x, w, s, p in layers]
    assert all(plans[tier] == plans[1] for tier in TIERS)
    for plan in plans[1]:
        assert plan.smem <= bic.MAX_SMEM and 1 <= plan.splits <= min(bic.MAX_SPLITS, plan.chunks)
        assert plan.block_n % plan.splits == 0 and plan.patch_pixels <= plan.units * plan.threads // 2


@pytest.mark.parametrize("config", CONFIGS)
def test_every_bf16_conv_of_the_window_is_a_conv2d(config):
    """Every bf16 convolution a served batch runs goes through Conv2d, the
    module that routes; the others (the UNet's and the VAE's conv_out, the
    quant convs) are plain nn.Conv2d calls in f32."""
    for *_, dtype, name in conv_layers(config, 2):
        assert name == "Conv2d" if dtype == torch.bfloat16 else dtype == torch.float32


class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the routing reads no more."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("card, dtype, window, taken", [
    (True, torch.bfloat16, True, True),
    (True, torch.bfloat16, False, False),
    (True, torch.float32, True, False),
    (False, torch.bfloat16, True, False),
])
def test_conv2d_takes_the_kernel_only_for_bf16_on_the_card_inside_the_window(card, dtype, window, taken):
    conv = Conv2d(4, 6, 3, stride=2, padding=1)
    x = torch.randn(3, 4, 8, 8).to(dtype)
    calls = []

    def launch(x, weight, bias, stride, padding):  # the kernel's stand-in: counts, then computes the plain version
        calls.append((tuple(x.shape), stride, padding))
        return bic.conv2d_plain(x.as_subclass(torch.Tensor), weight, bias, stride, padding)

    want = bic.conv2d_plain(x, conv.weight, conv.bias, conv.stride, conv.padding)
    with mock.patch.object(unet2d, "batch_invariant_conv2d", launch), torch.no_grad(), \
            batch_invariant.window() if window else contextlib.nullcontext():
        assert torch.backends.cudnn.enabled != window
        y = conv(x.as_subclass(_OnTheCard) if card else x)
    assert calls == ([((3, 4, 8, 8), (2, 2), (1, 1))] if taken else [])
    torch.testing.assert_close(y.as_subclass(torch.Tensor), want, rtol=0, atol=0)


def test_a_unet_and_decoder_in_the_window_launch_the_kernel_once_per_bf16_conv():
    """A tiny bf16 UNet forward and VAE decode on a tensor that says it lies
    on the card, inside the window: the stand-in counts one launch per Conv2d
    call and none for the f32 output convolutions. (The outputs are not
    compared bit for bit: on the CPU a bf16 F.conv2d returns channels-last
    tensors, the kernel's route contiguous ones, and the CPU's GroupNorm
    rounds the two layouts differently.)"""
    g = torch.Generator().manual_seed(0)
    unet = UNet2D(unconditional_config(sample_size=(16, 16), block_out_channels=(32, 64), norm_num_groups=8,
                                       down_block_types=("DownBlock2D", "DownBlock2D"),
                                       up_block_types=("UpBlock2D", "UpBlock2D"), dtype="bfloat16")).init_params(g)
    vae = AutoencoderKL(VAEConfig(sample_size=32, block_out_channels=(16, 32), norm_num_groups=8,
                                  dtype="bfloat16")).init_params(g)
    calls = []

    def launch(x, weight, bias, stride, padding):  # the result says it lies on the card too
        calls.append(tuple(weight.shape))
        return bic.conv2d_plain(x.as_subclass(torch.Tensor), weight, bias, stride, padding).as_subclass(_OnTheCard)

    n_bf16 = sum(isinstance(m, Conv2d) for m in unet.modules()) + sum(
        isinstance(m, Conv2d) for m in vae.decoder.modules())
    z = torch.randn(2, 16, 16, 1, generator=g)
    with torch.inference_mode():
        want = unet(z, torch.tensor(10)), vae.decode(z)
        with mock.patch.object(unet2d, "batch_invariant_conv2d", launch), batch_invariant.window():
            got = unet(z.as_subclass(_OnTheCard), torch.tensor(10)), vae.decode(z.as_subclass(_OnTheCard))
    assert len(calls) == n_bf16
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32 and torch.isfinite(a).all()
