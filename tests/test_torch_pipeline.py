"""Port parity of the pipeline: tiny latent and pixel pipelines (Mel 32x32,
n_iter 4, 3 steps, batch 2) in both packages on the CPU, fed the same
weights, noise, posterior draw, step noise and Griffin-Lim phase; the
audio-to-audio modes, masks, stochastic sampling and DDPM; and that the
port imports no JAX. DDIM inversion, slerp, the diffusers-layout save/load
and sharded inference are in test_torch_pipeline_interop.py, on these
helpers.

Tolerances: uint8 spectrograms differ by at most 1 on at most 0.5% of the
pixels; int16 audio by at most 2 LSB given one spectrogram and phase;
scheduler math 1e-6."""

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
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_torch.utils.convert import to_torch, unet_state_dict, vae_state_dict
from audio_diffusion_tpu.mel import Mel
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig
from audio_diffusion_tpu.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_tpu.pipelines.pipeline import postprocess_images as jax_postprocess
from audio_diffusion_tpu.schedulers import DDIMScheduler, DDPMScheduler, SchedulerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_KW = dict(sample_size=(16, 16), block_out_channels=(32, 64),
               down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
               layers_per_block=1, norm_num_groups=8, attention_head_dim=8, fused_groupnorm=True)
VAE_KW = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4, sample_size=32)
MEL_KW = dict(x_res=32, y_res=32, hop_length=512, n_iter=4)
FULL = 32 * 512  # one slice of audio, x_res * hop


def _pair(unet_kw, vae_kw=None, scheduler="ddim"):
    """One random-weight pipeline in each package, the same weights."""
    cfg = UNetConfig(**unet_kw)
    params = random_params(UNet2D(cfg).init_params, 10)
    unet = TorchUNet(TorchUNetConfig(**unet_kw))
    unet.load_state_dict(to_torch(unet_state_dict(params, cfg)), strict=True)
    jvae = jvparams = tvae = None
    if vae_kw is not None:
        vcfg = VAEConfig(**vae_kw)
        jvae, jvparams = AutoencoderKL(vcfg), random_params(AutoencoderKL(vcfg).init_params, 11)
        tvae = TorchVAE(TorchVAEConfig(**vae_kw))
        tvae.load_state_dict(to_torch(vae_state_dict(jvparams, vcfg)), strict=True)
    sched_cfg = dict(num_train_timesteps=100) if scheduler == "ddpm" else {}
    jsched = (DDPMScheduler if scheduler == "ddpm" else DDIMScheduler)(SchedulerConfig(**sched_cfg))
    tsched = (TorchDDPM if scheduler == "ddpm" else TorchDDIM)(TorchSchedulerConfig(**sched_cfg))
    jpipe = AudioDiffusionPipeline(UNet2D(cfg), params, Mel(**MEL_KW), jsched, jvae, jvparams)
    tpipe = TorchPipeline(unet, TorchMel(**MEL_KW, device="cpu"), tsched, tvae, device="cpu")
    return jpipe, tpipe


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch intra-op thread for a module of tiny-model tests (this one and
    those that import this fixture): their ops are small, and beside the other
    test processes that share every core a pool of threads per op mostly waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pipes():
    return _pair(UNET_KW, VAE_KW)


def _jax_draws(key, batch, latent_shape, steps):
    """The JAX __call__'s draws from ``key`` (pipeline.py:369 split order):
    GL phase, the posterior's standard normal draw of a single clip, and the
    variance noise of each step from the scalar step-key chain (common.py:25-54)."""
    key, _, vae_key, gl_key = jax.random.split(key, 4)
    phase = torch.from_numpy(np.array(2.0 * jnp.pi * jax.random.uniform(gl_key, (batch, 32, 1025))))
    eps = torch.from_numpy(np.array(jax.random.normal(vae_key, (1, *latent_shape))))
    chain = np.zeros((steps, batch, *latent_shape), np.float32)
    for i in range(steps):
        key, sub = jax.random.split(key)
        chain[i] = np.array(jax.random.normal(sub, (batch, *latent_shape)))
    return phase, eps, torch.from_numpy(chain)


def _assert_uint8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), (diff > 0).mean())


def _noise(seed, shape=(2, 16, 16, 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _state_dicts_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)


def test_latent_pipeline_matches_jax(pipes):
    jpipe, tpipe = pipes
    noise = _noise(12)
    key = jax.random.key(13)
    raw_j, audio_j = jpipe(batch_size=2, steps=3, key=key, noise=jnp.asarray(noise), return_arrays=True,
                           pcm16=True)
    raw_j, audio_j = np.asarray(raw_j), np.asarray(audio_j)
    phase, _, _ = _jax_draws(key, 2, (16, 16, 1), 0)
    raw_t, audio_t = tpipe(batch_size=2, steps=3, noise=torch.from_numpy(noise), gl_phase=phase,
                           return_arrays=True, pcm16=True)
    raw_t, audio_t = raw_t.numpy(), audio_t.numpy()

    assert raw_t.shape == raw_j.shape == (2, 32, 32) and raw_t.dtype == np.uint8
    _assert_uint8_close(raw_t, raw_j)
    assert audio_t.shape == audio_j.shape == (2, 31 * 512) and audio_t.dtype == np.int16

    # Audio contract (bench.py:194): from the JAX spectrogram and the same phase,
    # the port's int16 PCM is within 2 LSB of the JAX pipeline's.
    audio_from_j = pcm16_quantize(tpipe.mel.images_to_audio(torch.from_numpy(raw_j), phase=phase)).numpy()
    lsb = np.abs(audio_from_j.astype(np.int32) - audio_j.astype(np.int32)).max()
    assert lsb <= 2, lsb


def _clips(seed, n):
    t = np.arange(FULL) / 22050
    rng = np.random.default_rng(seed)
    return np.stack([(0.5 * np.sin(2 * np.pi * (220 + 110 * i) * t) + 0.05 * rng.standard_normal(FULL))
                     for i in range(n)]).astype(np.float32)


# (input mode, start_step, mask seconds at the start and the end)
A2A_CASES = {"batched": ("batched", 1, 0.0), "single": ("single", 1, 0.0),
             "single masked": ("single", 2, 0.1), "batched masked from noise": ("batched", 0, 0.1)}


@pytest.mark.parametrize("case", list(A2A_CASES))
def test_audio_to_audio_matches_jax(pipes, case):
    """raw_audio as (B, samples) rows ("batched": posterior mode) or one clip
    broadcast over the batch ("single": a posterior sample, its draw
    injected), re-noised at ``timesteps[start_step - 1]``, with and without
    the column masks (the current-t noise level, pipeline.py:23-26)."""
    jpipe, tpipe = pipes
    mode, start_step, mask = A2A_CASES[case]
    clips = _clips(14, 2)
    raw_audio = clips if mode == "batched" else clips[0, : FULL - 100]
    noise = _noise(15)
    key = jax.random.key(16)
    kw = dict(raw_audio=raw_audio, start_step=start_step, steps=3, mask_start_secs=mask, mask_end_secs=mask,
              return_arrays=True)
    raw_j, _ = jpipe(noise=jnp.asarray(noise), key=key, **kw)
    phase, eps, _ = _jax_draws(key, 2, (16, 16, 1), 0)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), gl_phase=phase, posterior_eps=eps, **kw)
    _assert_uint8_close(raw_t.numpy(), raw_j)
    if mode == "single":  # the sample, not the mode: the draw reached the latents
        raw_mode, _ = tpipe(noise=torch.from_numpy(noise), gl_phase=phase, posterior_eps=torch.zeros_like(eps), **kw)
        assert not np.array_equal(raw_mode.numpy(), raw_t.numpy())


@pytest.mark.parametrize("scheduler, eta", [("ddim", 0.6), ("ddpm", 0.0)])
def test_stochastic_sampling_matches_jax(scheduler, eta):
    """DDIM eta > 0 and DDPM, the JAX step-key chain's noise injected."""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW, scheduler)
    noise = _noise(17)
    key = jax.random.key(18)
    raw_j, _ = jpipe(noise=jnp.asarray(noise), key=key, steps=3, eta=eta, return_arrays=True)
    phase, _, chain = _jax_draws(key, 2, (16, 16, 1), 3)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, eta=eta, gl_phase=phase, step_noise=chain,
                     return_arrays=True)
    _assert_uint8_close(raw_t.numpy(), raw_j)
    assert tpipe.get_default_steps() == jpipe.get_default_steps()


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
            "audio_diffusion_torch.utils.convert, audio_diffusion_torch.utils.diffusers_io, "
            "audio_diffusion_torch.ops._build, audio_diffusion_torch.ops.audio_io, "
            "audio_diffusion_torch.schedulers.ddpm, audio_diffusion_torch.serving, "
            "audio_diffusion_torch.serving.__main__, audio_diffusion_torch.training, "
            "audio_diffusion_torch.training.__main__, audio_diffusion_torch.training.train_vae, "
            "audio_diffusion_torch.training.perceptual, audio_diffusion_torch.data.dataset, "
            "audio_diffusion_torch.models.ema, audio_diffusion_torch.audio_diffusion, audio_diffusion_torch.apps, "
            "audio_diffusion_torch.pipelines.stitch, audio_diffusion_torch.ops.beat, audio_diffusion_torch.utils.hub, "
            "audio_diffusion_torch.utils.ldm_import, audio_diffusion_torch.utils.profiling, "
            "audio_diffusion_torch.utils.batch_invariant, "
            "audio_diffusion_torch.data.native_audio, audio_diffusion_torch.data.prepare, "
            "audio_diffusion_torch.scripts.audio_to_images, audio_diffusion_torch.scripts.encode_audio, "
            "audio_diffusion_torch.scripts.convert_checkpoint, audio_diffusion_torch.parallel, "
            "audio_diffusion_torch.utils.flax_msgpack, audio_diffusion_torch.utils.safetensors_io, "
            "audio_diffusion_torch.scripts.make_audio, audio_diffusion_torch.scripts.cond_selectivity_evidence, "
            "audio_diffusion_torch.scripts.rebuild, audio_diffusion_torch.scripts.rebuild_latent256, "
            "audio_diffusion_torch.scripts.rebuild_latent512, "
            "audio_diffusion_torch.examples.test_mel, audio_diffusion_torch.examples.test_model, "
            "audio_diffusion_torch.examples.test_vae, audio_diffusion_torch.examples.train_model, "
            "audio_diffusion_torch.examples.latent_diffusion, audio_diffusion_torch.examples.conditional_generation; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'msgpack', 'safetensors', 'audio_diffusion_tpu') "
            "if m in sys.modules]; "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    # and no import of them anywhere in the package's sources or chip_smoke.py, inside functions too
    import re

    banned = re.compile(r"^\s*(?:import|from)\s+(jax|flax|optax|msgpack|safetensors|audio_diffusion_tpu)\b", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _, files in os.walk(os.path.join(REPO, "audio_diffusion_torch"))
        for f in files if f.endswith(".py")]
    found = {p: m.group(1) for p in sources for m in [banned.search(open(p).read())] if m}
    assert not found, found
