"""The port's fused request path (``pipe.fuse``, the counterpart of the JAX
package's ``_fused_generate_fn``), mirroring tests/test_pipeline.py:331-475 on
tiny pipelines on the CPU, where the program function runs without a capture:

- ``fuse=True`` against the eager path (``pipe._uncaptured()``): bitwise equal
  spectrograms and audio within 1 int16 LSB (the JAX package's own bound for
  fused against staged), and the generators left in the same state, so the
  draws were made in the eager order; for generated noise with pcm16, user
  noise with eta 0.5 and a step generator, DDPM, per-row step generators,
  the latent conditional path, audio-to-audio batched and single with masks,
  and a stochastic request split into several segments;
- ``return_images_only`` runs the staged path's prep, denoise and decode
  programs (tests/test_torch_staged.py holds the staged path);
- against the JAX package's fused path with the JAX draws injected, at the
  tolerances of tests/test_torch_pipeline.py;
- the cache: one program per signature, a new one for other steps, eta,
  cuDNN setting or compute dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import FULL, UNET_KW, VAE_KW, _assert_uint8_close, _clips, _jax_draws, _noise, _pair

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
from audio_diffusion_torch.ops.attention import deterministic_algorithms
from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
from audio_diffusion_torch.pipelines import pipeline as pipeline_module
from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize
from audio_diffusion_torch.schedulers import DDIMScheduler, DDPMScheduler, SchedulerConfig

MEL_KW = dict(x_res=32, y_res=32, hop_length=512, n_iter=4)
COND_KW = dict(UNET_KW, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4, cross_attention_dim=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the fastest for these tiny tensors, and the file
    keeps its time when other test processes load every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pipeline(unet_kw, vae=True, scheduler=None):
    unet = UNet2D(UNetConfig(**unet_kw)).init_params(torch.Generator().manual_seed(0))
    vqvae = AutoencoderKL(VAEConfig(**VAE_KW)).init_params(torch.Generator().manual_seed(1)) if vae else None
    return AudioDiffusionPipeline(unet, Mel(**MEL_KW, device="cpu"),
                                  scheduler or DDIMScheduler(SchedulerConfig(num_train_timesteps=100)), vqvae,
                                  device="cpu")


@pytest.fixture(scope="module")
def latent():
    return _pipeline(UNET_KW)


@pytest.fixture(scope="module")
def pixel_ddpm():
    return _pipeline(dict(UNET_KW, sample_size=(32, 32)), vae=False,
                     scheduler=DDPMScheduler(SchedulerConfig(num_train_timesteps=100)))


@pytest.fixture(scope="module")
def conditional():
    return _pipeline(COND_KW)


def _generators(seed):
    return torch.Generator().manual_seed(seed)


# name -> (pipeline fixture, the call's arguments; generators made afresh for each call)
CASES = {
    "generated noise, pcm16": ("latent", lambda: dict(batch_size=2, steps=3, generator=_generators(11), pcm16=True)),
    "user noise, eta 0.5, step generator": ("latent", lambda: dict(
        noise=torch.from_numpy(_noise(1)), steps=3, eta=0.5, generator=_generators(2),
        step_generator=_generators(3))),
    "ddpm": ("pixel_ddpm", lambda: dict(batch_size=2, steps=4, generator=_generators(4), pcm16=True)),
    "per-row step generators": ("latent", lambda: dict(
        batch_size=2, steps=3, eta=1.0, generator=_generators(5), step_generator=[_generators(6), _generators(7)])),
    "latent conditional": ("conditional", lambda: dict(
        batch_size=2, steps=3, generator=_generators(8), pcm16=True,
        encoding=np.random.default_rng(9).standard_normal((2, 12)).astype(np.float32))),
    "audio-to-audio single, masks": ("latent", lambda: dict(
        batch_size=2, raw_audio=_clips(10, 1)[0, : FULL - 1], start_step=2, steps=4, generator=_generators(13),
        mask_start_secs=0.05, mask_end_secs=0.05, pcm16=True)),
    "audio-to-audio batched, masks, eta": ("latent", lambda: dict(
        raw_audio=_clips(14, 2), noise=torch.from_numpy(_noise(15)), start_step=1, steps=3, eta=0.5,
        generator=_generators(16), step_generator=_generators(17), mask_start_secs=0.05)),
}


def _run(pipe, fuse, kw):
    """The fused call, or without ``fuse`` the eager one, op by op outside any program."""
    if fuse:
        return pipe(return_arrays=True, **kw)
    with pipe._uncaptured():
        return pipe(return_arrays=True, **kw)


def _states(kw):
    gens = [kw["generator"], *np.atleast_1d(kw.get("step_generator", []))]
    return [g.get_state() for g in gens]


@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_eager(case, request):
    """Bitwise spectrograms, audio within 1 int16 LSB (the JAX package's
    fused-vs-staged bound: fusing may reorder Griffin-Lim's f32 sums), and
    every generator left where the eager call leaves it."""
    name, make = CASES[case]
    pipe = request.getfixturevalue(name)
    fused_kw, eager_kw = make(), make()
    raw_f, audio_f = _run(pipe, True, fused_kw)
    raw_e, audio_e = _run(pipe, False, eager_kw)
    assert raw_f.dtype == torch.uint8 and raw_f.shape == (2, 32, 32)
    assert torch.equal(raw_f, raw_e)
    assert audio_f.dtype == audio_e.dtype and audio_f.shape == audio_e.shape
    assert (audio_f.double() - audio_e.double()).abs().max() <= (1 if audio_f.dtype == torch.int16 else 1 / 32767)
    for a, b in zip(_states(fused_kw), _states(eager_kw)):
        assert torch.equal(a, b)


def test_stochastic_request_in_segments_matches_eager(latent, monkeypatch):
    """Above STEP_NOISE_BYTES of step noise a signature is captured as
    several segments, each replay's draws made just before it; the result
    and the generator's state are the eager call's."""
    monkeypatch.setattr(pipeline_module, "STEP_NOISE_BYTES", 2 * 2 * 16 * 16 * 4)  # two steps of batch 2
    make = CASES["user noise, eta 0.5, step generator"][1]
    fused_kw, eager_kw = dict(make(), steps=5), dict(make(), steps=5)
    latent._compiled.clear()
    raw_f, audio_f = _run(latent, True, fused_kw)
    (prog,) = latent._compiled.values()
    assert prog.segments == [(0, 2), (2, 4), (4, 5)]
    raw_e, audio_e = _run(latent, False, eager_kw)
    assert torch.equal(raw_f, raw_e) and (audio_f - audio_e).abs().max() <= 1 / 32767
    for a, b in zip(_states(fused_kw), _states(eager_kw)):
        assert torch.equal(a, b)


def test_return_images_only_runs_the_stage_programs(latent):
    """As in the JAX package (pipeline.py:452, 505-591): off the fused
    program, onto the staged path's programs, denoise and decode (no prep
    without input audio, no audio stage); the fused call's spectrograms."""
    latent._compiled.clear()
    raw = latent(batch_size=2, steps=3, generator=_generators(20), return_images_only=True)
    assert [k[0] for k in latent._compiled] == ["denoise", "vae_decode"]
    fused, _ = latent(batch_size=2, steps=3, generator=_generators(20), return_arrays=True)
    assert raw.dtype == np.uint8 and raw.shape == (2, 32, 32)
    np.testing.assert_array_equal(raw, fused.numpy())


def test_cache_holds_one_program_per_signature(latent):
    """The same signature returns the same program; other steps, eta, cuDNN
    setting (on or off, its deterministic algorithms), torch's deterministic
    algorithms or UNet (another compute dtype) make a new one."""
    latent._compiled.clear()
    latent(batch_size=2, steps=2, generator=_generators(1), return_arrays=True)
    (key,) = latent._compiled
    prog = latent._compiled[key]
    assert key == latent.signature(2, 0.0, 2, None, False, 0, 0, 0, "none")
    latent(noise=torch.from_numpy(_noise(2)), steps=2, generator=_generators(3), return_arrays=True)
    assert list(latent._compiled) == [key] and latent._compiled[key] is prog

    latent(batch_size=2, steps=3, generator=_generators(1), return_arrays=True)
    latent(batch_size=2, steps=2, eta=0.5, generator=_generators(1), return_arrays=True)
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = not enabled
    try:
        latent(batch_size=2, steps=2, generator=_generators(1), return_arrays=True)
    finally:
        torch.backends.cudnn.enabled = enabled
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not deterministic
    try:
        latent(batch_size=2, steps=2, generator=_generators(1), return_arrays=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with deterministic_algorithms():
        latent(batch_size=2, steps=2, generator=_generators(1), return_arrays=True)
    unet = latent.unet
    bf16 = UNet2D(dataclasses.replace(unet.config, dtype="bfloat16"))
    bf16.load_state_dict(unet.state_dict())
    latent.unet = bf16
    try:
        latent(batch_size=2, steps=2, generator=_generators(1), return_arrays=True)
    finally:
        latent.unet = unet
    keys = list(latent._compiled)
    assert len(keys) == 7 and keys[0] == key
    changed = [{i for i, (a, b) in enumerate(zip(key, k)) if a != b} for k in keys[1:]]
    # steps, eta, cudnn.enabled, cudnn.deterministic, torch's deterministic algorithms, the UNet (its dtype)
    assert changed == [{1}, {2}, {13}, {14}, {15}, {11, 18}], changed


def test_fused_matches_the_jax_fused_path():
    """The port's fused call against the JAX package's fused call
    (``fuse=True`` in both) on one stochastic single-clip audio-to-audio
    request with masks, the JAX draws injected: the posterior eps, the
    step-key chain and the Griffin-Lim phase. Spectrograms within 1 uint8 on
    at most 0.5% of the pixels; from the JAX spectrogram and phase, audio
    within 2 int16 LSB (tests/test_torch_pipeline.py's tolerances)."""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW)
    assert jpipe.fuse and tpipe.fuse
    noise = _noise(21)
    key = jax.random.key(22)
    kw = dict(raw_audio=_clips(23, 1)[0, : FULL - 1], start_step=1, steps=3, eta=0.5, mask_start_secs=0.05,
              mask_end_secs=0.05, return_arrays=True, pcm16=True)
    raw_j, audio_j = (np.asarray(a) for a in jpipe(noise=jnp.asarray(noise), key=key, **kw))
    phase, eps, chain = _jax_draws(key, 2, (16, 16, 1), 2)
    raw_t, audio_t = tpipe(noise=torch.from_numpy(noise), gl_phase=phase, posterior_eps=eps, step_noise=chain, **kw)
    assert len(tpipe._compiled) == 1
    _assert_uint8_close(raw_t.numpy(), raw_j)
    assert audio_t.dtype == torch.int16 and audio_t.shape == audio_j.shape
    from_j = pcm16_quantize(tpipe.mel.images_to_audio(torch.from_numpy(raw_j), phase=phase)).numpy()
    assert np.abs(from_j.astype(np.int32) - audio_j.astype(np.int32)).max() <= 2
