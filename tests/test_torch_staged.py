"""The port's staged path (``fuse=False`` and ``return_images_only``, the
counterpart of the JAX package's staged path, pipeline.py:505-612) and its
cached DDIM inversion (``encode``, pipeline.py:140-150, 615-652) on tiny
pipelines on the CPU, where every stage's program runs without a capture:

- staged against fused, bitwise (spectrograms and audio) with the
  generators left where the fused call leaves them, on the request kinds of
  tests/test_torch_fused.py (generation, audio-to-audio with masks, the
  latent conditional path, DDPM, eta with one and with per-row step
  generators), as tests/test_pipeline.py:331-437 holds the JAX package's
  fused path against its staged one; and staged against the eager path
  (``pipe._uncaptured()``), bitwise;
- a stochastic staged request split into segments, and a sharded one;
- the keys in ``pipe._compiled``: one program per stage signature, reused by
  a second call with other data, which gives that call's result;
- against the JAX package's staged path (``fuse = False``) with the JAX
  draws injected, at tests/test_torch_pipeline.py's tolerances: uint8 within
  1 on at most 0.5% of the pixels, int16 audio within 2 LSB from one
  spectrogram and phase;
- ``encode`` bitwise its eager run, and against the JAX ``encode`` within
  1e-4 of the largest |value| (tests/test_torch_pipeline_interop.py:48).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import CASES, _generators, _pipeline, _run, _states
from test_torch_fused import conditional, latent, one_thread, pixel_ddpm  # noqa: F401 (fixtures)
from test_torch_pipeline import FULL, UNET_KW, VAE_KW, _assert_uint8_close, _clips, _jax_draws, _noise, _pair

from audio_diffusion_torch.parallel import make_mesh
from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
from audio_diffusion_torch.pipelines import pipeline as pipeline_module
from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize


def _staged(pipe, kw):
    pipe.fuse = False
    try:
        return pipe(return_arrays=True, **kw)
    finally:
        pipe.fuse = True


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_staged_matches_fused_and_eager_bitwise(case, request):
    """Spectrograms and audio bitwise the fused call's and the eager call's,
    every generator left where they leave it: the draws keep the eager order."""
    name, make = CASES[case]
    pipe = request.getfixturevalue(name)
    kws = [make() for _ in range(3)]
    staged = _staged(pipe, kws[0])
    assert {k[0] for k in pipe._compiled} >= {"denoise", "vae_decode" if pipe.is_latent else "postprocess", "audio"}
    assert _equal(staged, _run(pipe, True, kws[1])) and _equal(staged, _run(pipe, False, kws[2]))
    for a, b, c in zip(*map(_states, kws)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_stochastic_staged_request_in_segments(latent, monkeypatch):
    """Above STEP_NOISE_BYTES the denoise stage runs as several segments,
    each one's step noise drawn just before it; bitwise the eager call."""
    monkeypatch.setattr(pipeline_module, "STEP_NOISE_BYTES", 2 * 2 * 16 * 16 * 4)  # two steps of batch 2
    make = CASES["user noise, eta 0.5, step generator"][1]
    kws = [dict(make(), steps=5) for _ in range(2)]
    latent._compiled.clear()
    staged = _staged(latent, kws[0])
    (denoise,) = [p for k, p in latent._compiled.items() if k[0] == "denoise"]
    assert denoise.segments == [(0, 2), (2, 4), (4, 5)] and "step_noise" in denoise.inputs
    assert _equal(staged, _run(latent, False, kws[1]))
    for a, b in zip(*map(_states, kws)):
        assert torch.equal(a, b)


def test_stage_programs_are_keyed_and_reused(latent):
    """One program per stage signature, keyed like the JAX package's; a
    second call with the same signature and other data reuses each of them
    and gives its own result (the eager call's), so the re-noised input, the
    mask's columns, the noise and the draws are inputs, not constants. The
    cuDNN flag is part of every key."""
    latent._compiled.clear()

    def call(seed, runner):
        return runner(dict(raw_audio=_clips(seed, 2), noise=torch.from_numpy(_noise(seed + 1)), start_step=1,
                           steps=3, eta=0.5, generator=_generators(seed + 2), step_generator=_generators(seed + 3),
                           mask_start_secs=0.05, pcm16=True))

    first = call(30, lambda kw: _staged(latent, kw))
    fixed = latent._fixed_key()
    t0 = int(latent.scheduler.schedule(3).timesteps[0])
    mask_start = int(0.05 * 16 * 22050 / 32 / 512)
    keys = list(latent._compiled)
    assert keys == [("prep", "batched", t0, 2) + fixed,
                    ("denoise", 3, 1, 0.5, mask_start, 0, "batched", None, 2) + fixed,
                    ("vae_decode", 2) + fixed, ("audio", True, 2) + fixed]
    programs = list(latent._compiled.values())
    second = call(40, lambda kw: _staged(latent, kw))
    assert list(latent._compiled) == keys and all(a is b for a, b in zip(latent._compiled.values(), programs))
    assert _equal(second, call(40, lambda kw: _run(latent, False, kw)))
    assert not torch.equal(first[0], second[0])

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = not enabled
    try:
        call(30, lambda kw: _staged(latent, kw))
        flipped = latent._fixed_key()
    finally:
        torch.backends.cudnn.enabled = enabled
    assert flipped != fixed and list(latent._compiled)[4:] == [k[: -len(fixed)] + flipped for k in keys]


def test_encode_programs_are_keyed_and_reused(latent):
    """``encode`` caches ``("vae_encode_mode", shape)`` and ``("encode",
    steps, shape)``; a second call reuses both and returns its own images'
    inversion, bitwise the eager one, as a tensor of its own."""
    images = [latent(batch_size=2, steps=3, generator=_generators(s)).images for s in (50, 51)]
    latent._compiled.clear()
    first = latent.encode(images[0], steps=3)
    fixed = latent._fixed_key()
    keys = [("vae_encode_mode", (2, 32, 32, 1)) + fixed, ("encode", 3, (2, 16, 16, 1)) + fixed]
    assert list(latent._compiled) == keys
    programs = list(latent._compiled.values())
    second = latent.encode(images[1], steps=3)
    assert list(latent._compiled) == keys and all(a is b for a, b in zip(latent._compiled.values(), programs))
    with latent._uncaptured():
        eager = [latent.encode(im, steps=3) for im in images]
    assert torch.equal(first, eager[0]) and torch.equal(second, eager[1]) and not torch.equal(first, second)
    assert first.data_ptr() != programs[1].state["x"].data_ptr()
    # the inversion's static input has the layout the eager loop sees, the VAE's
    assert programs[1].inputs["x"].stride() == programs[0].state["x"].stride()


def test_a_program_refuses_an_input_of_another_layout(latent):
    """A program's static inputs keep the strides of the tensors it was made
    for (a graph's kernels can depend on them): another layout raises."""
    key = ("layout probe",)
    latent._compiled[key] = latent._stage(key, {"x": torch.zeros((2, 16, 16, 1))})
    nchw = torch.zeros((2, 1, 16, 16)).permute(0, 2, 3, 1)  # the same shape, channel stride 256
    try:
        with pytest.raises(RuntimeError, match="strides"):
            latent._stage(key, {"x": nchw})
    finally:
        del latent._compiled[key]


def test_sharded_staged_request_matches_unsharded(latent):
    """Each replica runs its own stage programs on its rows (two rows a
    replica: the CPU's lone row takes other kernels); the gathered rows are
    the unsharded staged call's."""
    sharded = AudioDiffusionPipeline(latent.unet, latent.mel, latent.scheduler, latent.vqvae,
                                     device="cpu").shard(make_mesh(devices=["cpu"] * 2))
    def kw():
        return dict(noise=torch.from_numpy(_noise(60, (4, 16, 16, 1))), steps=3, eta=0.5, generator=_generators(61),
                    step_generator=_generators(62))

    got, want = _staged(sharded, kw()), _staged(latent, kw())
    assert _equal(got, want)
    (denoise,) = [k for k in sharded._compiled if k[0] == "denoise"]
    assert denoise[:9] == ("denoise", 3, 0, 0.5, 0, 0, "none", None, 2)


def test_images_only_and_staged_match_the_jax_staged_path():
    """The port's staged call against the JAX package's (``fuse = False`` in
    both), the JAX draws injected: a stochastic single-clip audio-to-audio
    request with masks (the posterior eps, the step-key chain and the
    Griffin-Lim phase), and a generation with ``return_images_only``."""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW)
    jpipe.fuse = tpipe.fuse = False
    noise = _noise(70)
    key = jax.random.key(71)
    kw = dict(raw_audio=_clips(72, 1)[0, : FULL - 1], start_step=1, steps=3, eta=0.5, mask_start_secs=0.05,
              mask_end_secs=0.05, return_arrays=True, pcm16=True)
    raw_j, audio_j = (np.asarray(a) for a in jpipe(noise=jnp.asarray(noise), key=key, **kw))
    phase, eps, chain = _jax_draws(key, 2, (16, 16, 1), 2)
    raw_t, audio_t = tpipe(noise=torch.from_numpy(noise), gl_phase=phase, posterior_eps=eps, step_noise=chain, **kw)
    assert [k[0] for k in tpipe._compiled] == ["prep", "denoise", "vae_decode", "audio"]
    _assert_uint8_close(raw_t.numpy(), raw_j)
    assert audio_t.dtype == torch.int16 and audio_t.shape == audio_j.shape
    from_j = pcm16_quantize(tpipe.mel.images_to_audio(torch.from_numpy(raw_j), phase=phase)).numpy()
    assert np.abs(from_j.astype(np.int32) - audio_j.astype(np.int32)).max() <= 2

    images_j = jpipe(noise=jnp.asarray(noise), steps=3, key=key, return_images_only=True)
    images_t = tpipe(noise=torch.from_numpy(noise), steps=3, return_images_only=True)
    assert isinstance(images_t, np.ndarray)
    _assert_uint8_close(images_t, images_j)


def test_encode_matches_jax_encode():
    """DDIM inversion over the VAE posterior mode, as cached programs."""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW)
    images = jpipe(noise=jnp.asarray(_noise(80)), steps=3, key=jax.random.key(81)).images
    enc_j = np.asarray(jpipe.encode(images, steps=3))
    enc_t = tpipe.encode(images, steps=3).numpy()
    assert [k[:2] for k in tpipe._compiled] == [("vae_encode_mode", (2, 32, 32, 1)), ("encode", 3)]
    assert enc_t.shape == enc_j.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(enc_t, enc_j, atol=1e-4 * np.abs(enc_j).max())


def test_pixel_encode_has_no_vae_program():
    """A pixel pipeline inverts the images themselves: one program."""
    pipe = _pipeline(dict(UNET_KW, sample_size=(32, 32)), vae=False)
    images = pipe(batch_size=1, steps=2, generator=_generators(90)).images
    got = pipe.encode(images, steps=2)
    assert [k[:3] for k in pipe._compiled if k[0] != "fused"] == [("encode", 2, (1, 32, 32, 1))]
    with pipe._uncaptured():
        assert torch.equal(got, pipe.encode(images, steps=2))
