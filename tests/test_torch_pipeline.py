"""Port parity of the pipeline: tiny latent and pixel pipelines (Mel 32x32,
n_iter 4, 3 steps, batch 2) in both packages on the CPU, fed the same
weights, noise, posterior draw, step noise and Griffin-Lim phase; the
audio-to-audio modes, masks, stochastic sampling, DDPM, DDIM inversion,
slerp and the diffusers-layout save/load in both directions; and that the
port imports no JAX.

Tolerances: uint8 spectrograms differ by at most 1 on at most 0.5% of the
pixels; int16 audio by at most 2 LSB given one spectrogram and phase;
scheduler math 1e-6."""

import dataclasses
import json
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
from audio_diffusion_tpu.utils.torch_export import save_pipeline_torch

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


@pytest.fixture(scope="module")
def pipes():
    return _pair(UNET_KW, VAE_KW)


@pytest.fixture(scope="module")
def pixel_pipes():
    return _pair(dict(UNET_KW, sample_size=(32, 32)))


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


def test_encode_and_slerp_match_jax(pipes):
    """DDIM inversion over the VAE posterior mode, fed back through noise=."""
    jpipe, tpipe = pipes
    images = jpipe(noise=jnp.asarray(_noise(19)), steps=3, key=jax.random.key(20)).images
    enc_j = np.asarray(jpipe.encode(images, steps=3))
    enc_t = tpipe.encode(images, steps=3).numpy()
    assert enc_t.shape == enc_j.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(enc_t, enc_j, atol=1e-4 * np.abs(enc_j).max())

    mixed_j = np.asarray(AudioDiffusionPipeline.slerp(enc_j[:1], enc_j[1:], 0.3))
    mixed_t = TorchPipeline.slerp(torch.from_numpy(enc_j[:1]), torch.from_numpy(enc_j[1:]), 0.3).numpy()
    np.testing.assert_allclose(mixed_t, mixed_j, atol=1e-6)

    noise = np.concatenate([enc_j, mixed_j])
    raw_j, _ = jpipe(noise=jnp.asarray(noise), steps=3, return_arrays=True)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, return_arrays=True)
    _assert_uint8_close(raw_t.numpy(), raw_j)


def _state_dicts_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["latent", "pixel"])
def test_diffusers_layout_loads_across_packages(pipes, pixel_pipes, kind, tmp_path, monkeypatch):
    """JAX ``save_pipeline_torch`` -> port ``from_pretrained``, and port
    ``save_pretrained`` -> JAX ``from_pretrained`` (its torch-import route):
    each loaded pipeline gives the other package's spectrograms."""
    # The JAX import route checks the converted weights against a template
    # from flax's init, which only needs its shapes; flax's own init runs op
    # by op on the CPU (~30 s for the VAE), so the template is made from
    # jax.eval_shape instead.
    for cls in (UNet2D, AutoencoderKL):
        def shapes_only(self, key, init=cls.init_params):
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: init(self, k), key))

        monkeypatch.setattr(cls, "init_params", shapes_only)
    jpipe, tpipe = pipes if kind == "latent" else pixel_pipes
    h, w = tpipe.sample_hw
    noise = _noise(21, (2, h, w, 1))
    raw_j, _ = jpipe(noise=jnp.asarray(noise), steps=3, return_arrays=True)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, return_arrays=True)

    save_pipeline_torch(jpipe, str(tmp_path / "from_jax"))
    loaded_t = TorchPipeline.from_pretrained(str(tmp_path / "from_jax"), fused_groupnorm=True, device="cpu")
    _state_dicts_equal(loaded_t.unet, tpipe.unet)
    assert loaded_t.unet.config == tpipe.unet.config and loaded_t.mel.config == tpipe.mel.config
    assert (loaded_t.vqvae is None) == (kind == "pixel")
    _assert_uint8_close(loaded_t(noise=torch.from_numpy(noise), steps=3, return_arrays=True)[0].numpy(), raw_j)

    tpipe.save_pretrained(str(tmp_path / "from_torch"))
    with open(tmp_path / "from_torch" / "model_index.json") as fh:
        assert json.load(fh)["_class_name"] == "AudioDiffusionPipeline"
    loaded_j = AudioDiffusionPipeline.from_pretrained(str(tmp_path / "from_torch"))
    assert dataclasses.replace(loaded_j.unet.config, fused_groupnorm=True) == jpipe.unet.config
    _assert_uint8_close(raw_t.numpy(), np.asarray(loaded_j(noise=jnp.asarray(noise), steps=3,
                                                           return_arrays=True)[0]))
    overridden = TorchPipeline.from_pretrained(str(tmp_path / "from_torch"), dtype="bfloat16", device="cpu")
    assert overridden.unet.config.dtype == "bfloat16" and not overridden.unet.config.fused_groupnorm
    if kind == "latent":
        assert overridden.vqvae.config.dtype == "bfloat16"
        _state_dicts_equal(overridden.vqvae, tpipe.vqvae)


def test_pipeline_output_and_unported_options(pipes, tmp_path):
    _, tpipe = pipes
    out = tpipe(batch_size=1, steps=2, generator=torch.Generator().manual_seed(0))
    assert out.raw_images.shape == (1, 32, 32) and out.images[0].size == (32, 32)
    assert out.audios[0].shape == (31 * 512,) and np.isfinite(out.audios[0]).all()
    images, (sr, audios) = tpipe(batch_size=1, steps=2, return_dict=False)
    assert sr == 22050 and len(images) == len(audios) == 1
    raw = tpipe(batch_size=1, steps=2, return_images_only=True)
    np.testing.assert_array_equal(raw, out.raw_images)  # the same seed-0 generator draws the same noise
    nchw = tpipe(noise=torch.from_numpy(_noise(22)).permute(0, 3, 1, 2), steps=2, return_images_only=True)
    np.testing.assert_array_equal(nchw, tpipe(noise=torch.from_numpy(_noise(22)), steps=2, return_images_only=True))
    with pytest.raises(ValueError, match="unconditional"):
        tpipe(batch_size=1, steps=2, encoding=np.zeros((1, 4)))
    with pytest.raises(ValueError, match="start_step .* must be < steps"):
        tpipe(batch_size=1, start_step=500, steps=3)
    with pytest.raises(ValueError, match="raw_audio batch"):
        tpipe(raw_audio=_clips(0, 3), noise=torch.from_numpy(_noise(0)), steps=2)
    with pytest.raises(ValueError, match="per-row step_generator"):
        tpipe(batch_size=2, steps=2, eta=1.0, step_generator=[torch.Generator()])
    with pytest.raises(FileNotFoundError, match="Hub model id"):
        TorchPipeline.from_pretrained("teticio/audio-diffusion-256", device="cpu")
    tpipe.save_pretrained(str(tmp_path))
    unet_dir = tmp_path / "unet"
    os.replace(unet_dir / "diffusion_pytorch_model.bin", unet_dir / "diffusion_pytorch_model.safetensors")
    with pytest.raises(ValueError, match="safetensors"):
        TorchPipeline.from_pretrained(str(tmp_path), device="cpu")


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


# ---------------------------------------------------- sharded inference (tests/test_pipeline.py:241-261, 310-336)

@pytest.fixture
def one_thread():
    """torch's CPU kernels give a row the same bits in any batch only on one
    thread (GroupNorm splits a group's reduction across threads when batch x
    groups is small) and with at least 2 rows (a lone row takes GEMV and
    another convolution kernel): the sharded tests run so, 2 rows per replica."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sharded(tpipe, n=2):
    """``tpipe``'s modules split over ``n`` shares of the CPU (``make_mesh`` allows a repeated device)."""
    from audio_diffusion_torch.parallel import make_mesh

    return TorchPipeline(tpipe.unet, TorchMel(**MEL_KW, device="cpu"), tpipe.scheduler, tpipe.vqvae,
                         device="cpu").shard(make_mesh(devices=["cpu"] * n))


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sharded_generation_matches_unsharded_and_jax(pipes, one_thread):
    """The sharded call is bitwise the unsharded one, with injected draws and
    with the draws of a generator (made on the primary device in the
    unsharded order), and within the port's tolerance of the JAX package's."""
    jpipe, tpipe = pipes
    sharded = _sharded(tpipe)
    noise = _noise(12, (4, 16, 16, 1))
    key = jax.random.key(13)
    raw_j, _ = jpipe(batch_size=4, steps=3, key=key, noise=jnp.asarray(noise), return_arrays=True, pcm16=True)
    phase, _, _ = _jax_draws(key, 4, (16, 16, 1), 0)
    kw = dict(noise=torch.from_numpy(noise), steps=3, gl_phase=phase, return_arrays=True, pcm16=True)
    got = sharded(**kw)
    _assert_equal(got, tpipe(**kw))
    _assert_uint8_close(got[0].numpy(), np.asarray(raw_j))
    for extra in ({}, {"eta": 0.7}):  # noise, then step noise of the shared chain, then the phase
        kw = dict(batch_size=4, steps=2, return_arrays=True, **extra)
        _assert_equal(sharded(generator=torch.Generator().manual_seed(3), **kw),
                      tpipe(generator=torch.Generator().manual_seed(3), **kw))
    out = sharded(batch_size=4, steps=2)
    assert len(out.audios) == 4 and out.raw_images.shape == (4, 32, 32)
    np.testing.assert_array_equal(sharded(batch_size=4, steps=2, return_images_only=True), out.raw_images)
    with pytest.raises(ValueError, match="multiple of the mesh's data-axis size"):
        sharded(batch_size=3, steps=2)


def test_sharded_audio_to_audio_matches_unsharded(pipes, one_thread):
    """Batched rows split with their clips; one broadcast clip takes its
    posterior draw from the generator on the primary device, as the
    unsharded call does."""
    _, tpipe = pipes
    sharded = _sharded(tpipe)
    batched = dict(raw_audio=_clips(14, 4), noise=torch.from_numpy(_noise(15, (4, 16, 16, 1))), start_step=1,
                   steps=3, mask_start_secs=0.1, return_arrays=True)
    single = dict(raw_audio=_clips(16, 1)[0], batch_size=4, start_step=1, steps=3, mask_end_secs=0.1,
                  return_arrays=True)
    for kw in (batched, single):
        _assert_equal(sharded(generator=torch.Generator().manual_seed(4), **kw),
                      tpipe(generator=torch.Generator().manual_seed(4), **kw))
    with pytest.raises(ValueError, match="raw_audio batch"):
        sharded(raw_audio=_clips(0, 2), noise=torch.from_numpy(_noise(0, (4, 16, 16, 1))), steps=2)


def test_sharded_conditional_and_per_row_generators(one_thread):
    """encoding= rows and per-row step generators split with their rows (DDPM: every step draws)."""
    kw = dict(UNET_KW, sample_size=(32, 32), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4, cross_attention_dim=12)
    unet = TorchUNet(TorchUNetConfig(**kw)).init_params(torch.Generator().manual_seed(5))
    tpipe = TorchPipeline(unet, TorchMel(**MEL_KW, device="cpu"),
                          TorchDDPM(TorchSchedulerConfig(num_train_timesteps=100)), device="cpu")
    sharded = _sharded(tpipe)
    enc = np.random.default_rng(6).standard_normal((4, 1, 12)).astype(np.float32)
    for gens in (None, lambda: [torch.Generator().manual_seed(s) for s in range(4)]):
        call = dict(batch_size=4, steps=3, encoding=enc, return_arrays=True)
        a = tpipe(generator=torch.Generator().manual_seed(7), step_generator=gens and gens(), **call)
        b = sharded(generator=torch.Generator().manual_seed(7), step_generator=gens and gens(), **call)
        _assert_equal(a, b)
    with pytest.raises(ValueError, match="encoding batch axis"):
        sharded(batch_size=2, steps=2, encoding=enc)
    from audio_diffusion_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="along 'data' only"):
        tpipe.shard(make_mesh(num_data=1, num_model=2, devices=["cpu", "cpu"]))


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
            "audio_diffusion_torch.data.native_audio, audio_diffusion_torch.data.prepare, "
            "audio_diffusion_torch.scripts.audio_to_images, audio_diffusion_torch.scripts.encode_audio, "
            "audio_diffusion_torch.scripts.convert_checkpoint, audio_diffusion_torch.parallel, "
            "audio_diffusion_torch.utils.flax_msgpack, audio_diffusion_torch.utils.safetensors_io, "
            "audio_diffusion_torch.scripts.make_audio, audio_diffusion_torch.scripts.cond_selectivity_evidence, "
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
