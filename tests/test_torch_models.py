"""Port parity of the models: utils/convert.py gives exactly the keys and
arrays of the JAX package's torch_export, the converted state dicts load
strict=True, and tiny f32 UNet (fused GroupNorm on, one attention level) and
VAE agree with the flax modules on the CPU at atol 1e-4 (the torch-twin bound).
A UNet row's bits do not depend on its batch on one CPU thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.models import AutoencoderKL as TorchVAE
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.utils.convert import to_torch, unet_state_dict, vae_state_dict
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig
from audio_diffusion_tpu.utils.torch_export import export_unet, export_vae

UNET_KW = dict(
    sample_size=(16, 16),
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    norm_num_groups=8,
    attention_head_dim=8,
    fused_groupnorm=True,
)
VAE_KW = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4, sample_size=16)
COND_KW = dict(sample_size=(16, 16), block_out_channels=(8, 16),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
               layers_per_block=1, norm_num_groups=4, attention_head_dim=4, cross_attention_dim=12)


def random_params(init_fn, seed):
    """A flax parameter tree of seeded numpy draws, shaped by ``init_fn``
    without running it (flax's own init is slow op by op on the CPU):
    kernels ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01),
    so every leaf, biases included, reaches the outputs."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.key(0))

    def draw(path, s):
        name = jax.tree_util.keystr(path[-1:])
        z = rng.standard_normal(s.shape).astype(np.float32)
        if "kernel" in name:
            return z / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if "scale" in name else 0.0) + 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def unet_pair():
    """The JAX UNet's config and seeded parameters, and the port's UNet holding them."""
    cfg = UNetConfig(**UNET_KW)
    params = random_params(UNet2D(cfg).init_params, 1)
    port = TorchUNet(TorchUNetConfig(**UNET_KW))
    port.load_state_dict(to_torch(unet_state_dict(params, cfg)), strict=True)
    return cfg, params, port


@pytest.fixture(scope="module")
def vae_pair():
    """The same for the VAE."""
    cfg = VAEConfig(**VAE_KW)
    params = random_params(AutoencoderKL(cfg).init_params, 3)
    port = TorchVAE(TorchVAEConfig(**VAE_KW))
    port.load_state_dict(to_torch(vae_state_dict(params, cfg)), strict=True)
    return cfg, params, port


def _same_state_dict(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_convert_matches_torch_export(unet_pair, vae_pair):
    cfg, params, port = unet_pair
    _same_state_dict(unet_state_dict(params, cfg), export_unet(params, cfg))
    assert sorted(port.state_dict()) == sorted(export_unet(params, cfg))
    vcfg, vparams, vport = vae_pair
    _same_state_dict(vae_state_dict(vparams, vcfg), export_vae(vparams, vcfg))
    assert sorted(vport.state_dict()) == sorted(export_vae(vparams, vcfg))


def test_unet_matches_flax(unet_pair):
    cfg, params, port = unet_pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([999, 37], dtype=np.int32)
    want = np.asarray(jax.jit(UNet2D(cfg).apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64))).numpy()
    assert got.shape == want.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_vae_matches_flax(vae_pair):
    cfg, params, port = vae_pair
    vae = AutoencoderKL(cfg)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: vae.apply({"params": p}, z, method=vae.decode))(params, z))
    x = rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: (lambda g: (g.mean, g.logvar))(
        vae.apply({"params": p}, x, method=vae.encode)))(params, x)
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z)).numpy()
        ours = port.encode(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(ours.mean.numpy(), np.asarray(mean), atol=1e-4)
    np.testing.assert_allclose(ours.logvar.numpy(), np.asarray(logvar), atol=1e-4)


def test_bf16_compute_keeps_f32_params(unet_pair):
    """dtype="bfloat16" computes in bf16 on f32 parameters and still returns
    an f32 prediction close to the f32 model's."""
    _, params, port = unet_pair
    cfg16 = TorchUNetConfig(**{**UNET_KW, "dtype": "bfloat16"})
    port16 = TorchUNet(cfg16)
    port16.load_state_dict(port.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    x = torch.randn(1, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y32, y16 = port(x, torch.tensor([500])), port16(x, torch.tensor([500]))
    assert y16.dtype == torch.float32
    assert (y16 - y32).abs().max() < 0.1 * y32.abs().max()


@pytest.mark.parametrize("remat", [False, True])
def test_configs_interchangeable_with_jax(tmp_path, remat):
    """config.json written by either package loads in the other, ``remat`` included."""
    kw = dict(UNET_KW, remat=remat)
    UNetConfig(**kw).save_config(str(tmp_path / "jax"))
    assert TorchUNetConfig.from_pretrained(str(tmp_path / "jax")) == TorchUNetConfig(**kw)
    TorchUNetConfig(**kw).save_config(str(tmp_path / "torch_unet"))
    assert UNetConfig.from_pretrained(str(tmp_path / "torch_unet")) == UNetConfig(**kw)
    TorchVAEConfig(**VAE_KW).save_config(str(tmp_path / "torch"))
    assert VAEConfig.from_pretrained(str(tmp_path / "torch")) == VAEConfig(**VAE_KW)


@pytest.mark.parametrize("kw", [UNET_KW, COND_KW], ids=["unconditional", "conditional"])
def test_unet_rows_do_not_depend_on_the_batch(kw):
    """Batch 4 and two batches of 2 give the same bits on one CPU thread,
    with one timestep (scalar or repeated per row, as a denoise step) and with
    per-row timesteps (as training). The time path's Linears run once per
    distinct timestep: at M=4 against M=2 the CPU GEMM picks another kernel."""
    cfg = UNetConfig(**kw)
    unet = TorchUNet(TorchUNetConfig(**kw))
    unet.load_state_dict(to_torch(unet_state_dict(random_params(UNet2D(cfg).init_params, 6), cfg)), strict=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 1)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((4, 1, 12)).astype(np.float32)) if cfg.is_conditional else None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            for t in (torch.tensor(500), torch.full((4,), 500), torch.tensor([999, 37, 999, 37])):
                whole = unet(x, t, ctx)
                halves = [unet(x[i:i + 2], t if t.dim() == 0 else t[i:i + 2], None if ctx is None else ctx[i:i + 2])
                          for i in (0, 2)]
                assert torch.equal(whole, torch.cat(halves)), t
    finally:
        torch.set_num_threads(threads)
