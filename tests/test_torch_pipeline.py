"""Port parity of the generation path: a tiny latent pipeline (Mel 32x32,
n_iter 4, 3 DDIM steps, batch 2) in both packages on the CPU, fed the same
noise, weights and Griffin-Lim phase; the DDIM step itself; and that the
port imports no JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_params

from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import AutoencoderKL as TorchVAE
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize, postprocess_images
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.utils.convert import to_torch, unet_state_dict, vae_state_dict
from audio_diffusion_tpu.mel import Mel
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig
from audio_diffusion_tpu.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_tpu.pipelines.pipeline import postprocess_images as jax_postprocess
from audio_diffusion_tpu.schedulers import DDIMScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_KW = dict(sample_size=(16, 16), block_out_channels=(32, 64),
               down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
               layers_per_block=1, norm_num_groups=8, attention_head_dim=8, fused_groupnorm=True)
VAE_KW = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4, sample_size=32)


@pytest.fixture(scope="module")
def pipes():
    cfg, vcfg = UNetConfig(**UNET_KW), VAEConfig(**VAE_KW)
    params = random_params(UNet2D(cfg).init_params, 10)
    vparams = random_params(AutoencoderKL(vcfg).init_params, 11)
    jpipe = AudioDiffusionPipeline(UNet2D(cfg), params, Mel(x_res=32, y_res=32, hop_length=512, n_iter=4),
                                   DDIMScheduler(), AutoencoderKL(vcfg), vparams)
    unet, vae = TorchUNet(TorchUNetConfig(**UNET_KW)), TorchVAE(TorchVAEConfig(**VAE_KW))
    unet.load_state_dict(to_torch(unet_state_dict(params, cfg)), strict=True)
    vae.load_state_dict(to_torch(vae_state_dict(vparams, vcfg)), strict=True)
    tmel = TorchMel(x_res=32, y_res=32, hop_length=512, n_iter=4, device="cpu")
    tpipe = TorchPipeline(unet, tmel, TorchDDIM(), vae, device="cpu")
    return jpipe, tpipe


def test_latent_pipeline_matches_jax(pipes):
    jpipe, tpipe = pipes
    noise = np.random.default_rng(12).standard_normal((2, 16, 16, 1)).astype(np.float32)
    key = jax.random.key(13)
    raw_j, audio_j = jpipe(batch_size=2, steps=3, key=key, noise=jnp.asarray(noise), return_arrays=True,
                           pcm16=True)
    raw_j, audio_j = np.asarray(raw_j), np.asarray(audio_j)
    gl_key = jax.random.split(key, 4)[3]  # pipeline.py:369 split order
    phase = torch.from_numpy(np.array(2.0 * jnp.pi * jax.random.uniform(gl_key, (2, 32, 1025))))
    raw_t, audio_t = tpipe(batch_size=2, steps=3, noise=torch.from_numpy(noise), gl_phase=phase,
                           return_arrays=True, pcm16=True)
    raw_t, audio_t = raw_t.numpy(), audio_t.numpy()

    assert raw_t.shape == raw_j.shape == (2, 32, 32) and raw_t.dtype == np.uint8
    diff = np.abs(raw_t.astype(np.int32) - raw_j.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), (diff > 0).mean())
    assert audio_t.shape == audio_j.shape == (2, 31 * 512) and audio_t.dtype == np.int16

    # Audio contract (bench.py:194): from the JAX spectrogram and the same phase,
    # the port's int16 PCM is within 2 LSB of the JAX pipeline's.
    audio_from_j = pcm16_quantize(tpipe.mel.images_to_audio(torch.from_numpy(raw_j), phase=phase)).numpy()
    lsb = np.abs(audio_from_j.astype(np.int32) - audio_j.astype(np.int32)).max()
    assert lsb <= 2, lsb


def test_pipeline_output_and_unported_options(pipes):
    _, tpipe = pipes
    out = tpipe(batch_size=1, steps=2, generator=torch.Generator().manual_seed(0))
    assert out.raw_images.shape == (1, 32, 32) and out.images[0].size == (32, 32)
    assert out.audios[0].shape == (31 * 512,) and np.isfinite(out.audios[0]).all()
    for kw in ({"start_step": 1}, {"raw_audio": np.zeros(100)}, {"encoding": np.zeros((1, 4))}, {"eta": 0.5}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe(batch_size=1, steps=2, **kw)


def test_ddim_step_and_postprocess_match_jax():
    rng = np.random.default_rng(14)
    x, eps = (rng.standard_normal((2, 8, 8, 1)).astype(np.float32) * 2 for _ in range(2))
    jsched, tsched = DDIMScheduler(), TorchDDIM()
    np.testing.assert_array_equal(tsched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))
    schedule = jsched.schedule(50)
    np.testing.assert_array_equal(tsched.schedule(50).timesteps, schedule.timesteps)
    for t in (980, 500, 0):
        want = np.asarray(jsched.step(jnp.asarray(eps), t, jnp.asarray(x), schedule))
        got = tsched.step(torch.from_numpy(eps), t, torch.from_numpy(x), tsched.schedule(50)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    # eta > 0: the JAX step draws its variance noise from the key (common.py::variance_noise); inject that draw.
    key = jax.random.key(15)
    want = np.asarray(jsched.step(jnp.asarray(eps), 500, jnp.asarray(x), schedule, eta=0.7, key=key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape, dtype=jnp.float32)))
    got = tsched.step(torch.from_numpy(eps), 500, torch.from_numpy(x), tsched.schedule(50), eta=0.7, noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(tsched.add_noise(torch.from_numpy(x), torch.from_numpy(eps), 500).numpy(),
                               np.asarray(jsched.add_noise(jnp.asarray(x), jnp.asarray(eps), 500)), atol=1e-6)
    img = rng.uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    img[0, 0, :4, 0] = [-1.0, 1.0, 0.5 / 127.5 - 1, 1.5 / 127.5 - 1]  # clip edges and .5 ties
    for c in (1, 3):
        np.testing.assert_array_equal(postprocess_images(torch.from_numpy(img[..., :c])).numpy(),
                                      np.asarray(jax_postprocess(jnp.asarray(img[..., :c]))))


def test_port_imports_no_jax():
    code = ("import sys, audio_diffusion_torch, audio_diffusion_torch.pipelines.pipeline, "
            "audio_diffusion_torch.utils.convert, audio_diffusion_torch.ops._build; "
            "bad = [m for m in ('jax', 'flax', 'audio_diffusion_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
