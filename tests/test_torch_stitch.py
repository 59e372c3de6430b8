"""Port parity of the convenience layer on the CPU: beat tracking and
``loop_it`` bitwise against the JAX package on click tracks and silence;
``outpaint``, serial ``remix`` and parallel ``remix`` of both packages driven
by one deterministic stub pipeline, stitched tracks bitwise equal (the
overlap bookkeeping without a model); the slice as a whole on a tiny latent
pipeline with the same weights in both packages and the JAX draws injected
(spectrograms within 1 uint8 on at most 0.5% of the pixels, int16 audio
within 2 LSB); serial remix's pinned generator; ``apps`` and the CUDA guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_beat_stitch import click_track
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_pipeline import UNET_KW, VAE_KW, _assert_uint8_close, _clips, _noise, _pair

from audio_diffusion_torch import apps
from audio_diffusion_torch.audio_diffusion import AudioDiffusion
from audio_diffusion_torch.ops import audio_io
from audio_diffusion_torch.ops import beat as tbeat
from audio_diffusion_torch.pipelines import stitch as tstitch
from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize
from audio_diffusion_tpu.audio_diffusion import AudioDiffusion as JaxAudioDiffusion
from audio_diffusion_tpu.ops import beat as jbeat
from audio_diffusion_tpu.pipelines import stitch as jstitch

SR = 22050


@pytest.mark.parametrize("bpm", [100, 120, 140, 0], ids=["100bpm", "120bpm", "140bpm", "silence"])
def test_beat_tracking_and_loop_it_bitwise(bpm):
    audio = click_track(bpm, 6.0, SR) if bpm else np.zeros(6 * SR, np.float32)
    env = tbeat.onset_strength(audio, SR)
    np.testing.assert_array_equal(env, jbeat.onset_strength(audio, SR))
    assert tbeat.estimate_tempo(env, SR) == jbeat.estimate_tempo(env, SR)
    for units in ("samples", "frames", "time"):
        (t_tempo, t_beats), (j_tempo, j_beats) = (tbeat.beat_track(audio, SR, units=units),
                                                  jbeat.beat_track(audio, SR, units=units))
        assert t_tempo == j_tempo
        np.testing.assert_array_equal(t_beats, j_beats)
    t_loop, j_loop = AudioDiffusion.loop_it(audio, SR, loops=3), JaxAudioDiffusion.loop_it(audio, SR, loops=3)
    if bpm:
        assert t_loop is not None and len(t_loop) % 3 == 0
        np.testing.assert_array_equal(t_loop, j_loop)
    else:
        assert t_loop is None and j_loop is None


# ------------------------------------------------------------ stub pipeline

class _Config:
    in_channels = 1


class _Unet:
    config = _Config()


class StubMel:
    x_res, hop_length = 16, 512

    def get_sample_rate(self):
        return SR


class StubPipe:
    """A duck-typed pipeline whose audio is a fixed function of ``raw_audio``;
    it ignores every key and generator. It records the state of each
    generator it is handed."""

    mel, unet, sample_hw, device = StubMel(), _Unet(), (4, 4), torch.device("cpu")

    def __init__(self):
        self.states = []

    def __call__(self, raw_audio=None, return_dict=True, return_arrays=False, generator=None, **kw):
        if generator is not None:
            self.states.append(generator.get_state())
        rows = np.asarray(raw_audio, np.float32)
        rows = rows[None] if rows.ndim == 1 else rows
        full = self.mel.x_res * self.mel.hop_length
        rows = np.pad(rows, ((0, 0), (0, max(0, full - rows.shape[1]))))[:, : (self.mel.x_res - 1) * self.mel.hop_length]
        audio = (0.9 * np.tanh(2.0 * rows) + 0.1 * np.roll(rows, 7, axis=-1) + 0.01).astype(np.float32)
        if return_arrays:
            return None, torch.from_numpy(audio)
        return [None] * len(audio), (SR, list(audio))


STITCH_CASES = {"outpaint": lambda m, pipe, audio, **kw: m.outpaint(pipe, audio[:7000], 3, overlap_secs=0.1, **kw),
                "remix": lambda m, pipe, audio, **kw: m.remix(pipe, audio, start_step=1, overlap_secs=0.1, **kw),
                "remix parallel": lambda m, pipe, audio, **kw: m.remix(pipe, audio, start_step=1, overlap_secs=0.1,
                                                                       parallel=True, **kw)}


@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_stitching_bitwise_with_a_stub_pipeline(case):
    """3 windows of overlap bookkeeping; the JAX parallel remix pads its
    batch to 4 rows, the port's calls exactly 3."""
    audio = (0.3 * np.random.default_rng(3).standard_normal(3 * 16 * 512 - 1000)).astype(np.float32)
    want = STITCH_CASES[case](jstitch, StubPipe(), audio, key=jax.random.key(1))
    pipe = StubPipe()
    got = STITCH_CASES[case](tstitch, pipe, audio, generator=torch.Generator().manual_seed(1))
    assert got.dtype == np.float32 and len(got) > len(audio) // 2
    np.testing.assert_array_equal(got, want)
    if case == "remix":  # pinned: every window sees the same generator state
        assert len(pipe.states) == 3 and all(torch.equal(s, pipe.states[0]) for s in pipe.states)


def test_stitch_rejects_oversized_overlap():
    pipe = StubPipe()
    window_secs = 16 * 512 / SR
    audio = np.zeros(4096, np.float32)
    for call in (lambda: tstitch.outpaint(pipe, audio, 1, overlap_secs=window_secs + 1),
                 lambda: tstitch.remix(pipe, audio, start_step=1, steps=2, overlap_secs=window_secs + 1),
                 lambda: tstitch.remix(pipe, audio, start_step=1, steps=2, overlap_secs=window_secs + 1,
                                       parallel=True)):
        with pytest.raises(ValueError, match="generation window"):
            call()


# ----------------------------------------------- tiny pipelines, both packages

def _jax_call_draws(key, batch, latent_hw, x_res):
    """What the JAX __call__ draws from ``key`` (pipeline.py:369): the noise,
    the posterior's standard normal draw of a single clip, the GL phase."""
    _, noise_key, vae_key, gl_key = jax.random.split(key, 4)
    noise = np.array(jax.random.normal(noise_key, (batch, *latent_hw, 1)))
    eps = np.array(jax.random.normal(vae_key, (1, *latent_hw, 1)))
    phase = np.array(2.0 * jnp.pi * jax.random.uniform(gl_key, (batch, x_res, 1025)))
    return torch.from_numpy(noise), torch.from_numpy(eps), torch.from_numpy(phase)


class Recorded:
    """A pipeline whose calls are recorded: (spectrogram, audio, GL phase).
    With ``key``, the port's pipeline takes each call's noise, posterior draw
    and GL phase from the JAX key that the JAX ``outpaint`` hands its pipeline."""

    def __init__(self, pipe, key=None):
        self.pipe, self.key, self.calls = pipe, key, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, generator=None, **kw):
        phase = None
        if self.key is not None:
            self.key, sub = jax.random.split(self.key)
            noise, eps, phase = _jax_call_draws(sub, 1, self.pipe.sample_hw, self.pipe.mel.x_res)
            kw.update(noise=noise, posterior_eps=eps, gl_phase=phase)
        images, (sr, audios) = self.pipe(**kw)
        self.calls.append((np.asarray(images[0]), np.asarray(audios[0]), phase))
        return images, (sr, audios)


@pytest.fixture(scope="module")
def audio_diffusions(tmp_path_factory):
    """AudioDiffusion of each package over the same tiny latent pipeline; the
    port's loaded from a diffusers-layout directory with fused_groupnorm=True."""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW)
    d = str(tmp_path_factory.mktemp("tiny_pipe"))
    tpipe.save_pretrained(d)
    tad = AudioDiffusion(d, fused_groupnorm=True, device="cpu")
    assert tad.pipe.unet.config.fused_groupnorm and tad.pipe.unet.config == tpipe.unet.config
    jad = JaxAudioDiffusion.__new__(JaxAudioDiffusion)
    jad.pipe = jpipe
    return jad, tad


def _assert_pcm_close(got, want):
    got, want = (pcm16_quantize(torch.as_tensor(np.array(x))).numpy().astype(np.int32) for x in (got, want))
    assert got.shape == want.shape and np.abs(got - want).max() <= 2


def _assert_window_close(tpipe, t_img, j_img, j_audio, phase):
    """The spectrograms within the uint8 bound; the audio contract of
    test_torch_pipeline: from the JAX spectrogram and the same GL phase, the
    port's int16 audio within 2 LSB of the JAX pipeline's."""
    _assert_uint8_close(t_img[None], j_img[None])
    _assert_pcm_close(tpipe.mel.images_to_audio(torch.tensor(j_img[None]), phase=phase)[0], j_audio)


def test_audio_diffusion_from_audio_with_a_mask_matches_jax(audio_diffusions):
    jad, tad = audio_diffusions
    clip, noise, key = _clips(30, 1)[0], _noise(31, (1, 16, 16, 1)), jax.random.key(32)
    kw = dict(raw_audio=clip, start_step=1, steps=3, mask_start_secs=0.2)
    j_img, (j_sr, j_audio) = jad.generate_spectrogram_and_audio_from_audio(key=key, noise=jnp.asarray(noise), **kw)
    _, eps, phase = _jax_call_draws(key, 1, (16, 16), 32)
    pipe = tad.pipe
    tad.pipe = lambda **call_kw: pipe(posterior_eps=eps, gl_phase=phase, **call_kw)
    try:
        t_img, (t_sr, t_audio) = tad.generate_spectrogram_and_audio_from_audio(noise=torch.from_numpy(noise), **kw)
    finally:
        tad.pipe = pipe
    assert t_sr == j_sr == SR and t_img.size == j_img.size == (32, 32) and t_audio.shape == (31 * 512,)
    _assert_window_close(pipe, np.asarray(t_img), np.asarray(j_img), j_audio, phase)
    image, (sr, audio) = tad.generate_spectrogram_and_audio(steps=2, generator=torch.Generator().manual_seed(0))
    assert image.size == (32, 32) and sr == SR and audio.shape == (31 * 512,) and np.isfinite(audio).all()


def test_outpaint_matches_jax(audio_diffusions):
    """2 windows at a 0.2 s overlap, each window's draws from the JAX key
    split: each window within the bounds, and each track the initial audio
    followed by its own windows past the overlap."""
    jad, tad = audio_diffusions
    initial, key = _clips(33, 1)[0][:20000], jax.random.key(34)
    jrec, trec = Recorded(jad.pipe), Recorded(tad.pipe, key)
    want = jstitch.outpaint(jrec, initial, 2, overlap_secs=0.2, steps=3, key=key)
    got = tstitch.outpaint(trec, initial, 2, overlap_secs=0.2, steps=3)
    overlap = int(0.2 * SR)
    assert len(got) == len(want) == len(initial) + 2 * (31 * 512 - overlap)
    for track, rec in ((got, trec), (want, jrec)):
        np.testing.assert_array_equal(track, np.concatenate([initial] + [a[overlap:] for _, a, _ in rec.calls]))
    for (t_img, _, phase), (j_img, j_audio, _) in zip(trec.calls, jrec.calls, strict=True):
        _assert_window_close(tad.pipe, t_img, j_img, j_audio, phase)


def test_serial_remix_pins_the_generator(audio_diffusions):
    """Every window of the serial remix starts from the generator state it was
    given: the first window is bitwise a direct call from that state; the
    parallel remix is one call of exactly one row per window."""
    _, tad = audio_diffusions
    pipe = tad.pipe
    track = _clips(35, 1)[0].repeat(3)[: 3 * 32 * 512 - 5000]
    slice_size, overlap = 32 * 512, int(0.2 * SR)
    out = tstitch.remix(pipe, track, start_step=1, overlap_secs=0.2, steps=3,
                        generator=torch.Generator().manual_seed(5))
    _, (_, first) = pipe(batch_size=1, raw_audio=track[:slice_size], start_step=1, steps=3,
                         generator=torch.Generator().manual_seed(5), return_dict=False)
    np.testing.assert_array_equal(out[: len(first[0])], first[0])
    n = len(track) // (slice_size - overlap)
    assert len(out) == 31 * 512 + (n - 1) * (31 * 512 - overlap)
    calls = []
    counted = lambda **kw: calls.append(np.asarray(kw["raw_audio"]).shape) or pipe(**kw)
    parallel = tstitch.remix(type("Counted", (), {"__call__": staticmethod(counted), "mel": pipe.mel,
                                                  "sample_hw": pipe.sample_hw, "unet": pipe.unet,
                                                  "device": pipe.device})(), track, start_step=1,
                             overlap_secs=0.2, steps=3, parallel=True)
    assert calls == [(n, slice_size)] and len(parallel) == len(out) and np.isfinite(parallel).all()


# ------------------------------------------------------------------ apps

class _StubAudioDiffusion:
    def __init__(self, model_id, device):
        self.model_id, self.device = model_id, device

    def generate_spectrogram_and_audio(self):
        audio = click_track(120, 6.0, SR)
        return np.zeros((64, 64), np.uint8), (SR, audio)


def test_apps_callback_cache_and_wav_bytes():
    """The gradio callback (reference: app.py:26-43): (image, (sr, audio),
    (sr, loop)), the loop the port's loop_it; one model per (id, device);
    wav_bytes is the port's audio_io.wav_bytes."""
    apps._cache.clear()
    try:
        image, (sr, audio), (sr2, loop) = apps.generate_spectrogram_audio_and_loop(
            "stub-model", factory=_StubAudioDiffusion, device="cpu")
        assert sr == sr2 == SR and image.shape == (64, 64)
        np.testing.assert_array_equal(loop, AudioDiffusion.loop_it(audio, SR))
        apps.generate_spectrogram_audio_and_loop("stub-model", factory=_StubAudioDiffusion, device="cpu")
        assert list(apps._cache) == [("stub-model", "cpu")] and apps._cache[("stub-model", "cpu")].device == "cpu"
    finally:
        apps._cache.clear()
    assert apps.wav_bytes is audio_io.wav_bytes
    assert apps.MODELS[0] == "teticio/audio-diffusion-256"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioDiffusion(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        apps.get_model(str(tmp_path))
    assert not apps._cache
