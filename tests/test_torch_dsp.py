"""Port parity of the mel DSP (audio_diffusion_torch.ops.*, .mel) against the
JAX package on the CPU: identical filterbank, bit-equal uint8 <-> dB, and
STFT/ISTFT/NNLS/Griffin-Lim agreement with the initial phase handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.ops import griffin_lim as tgl
from audio_diffusion_torch.ops import mel_filters as tmf
from audio_diffusion_torch.ops import stft as tst
from audio_diffusion_tpu.ops import griffin_lim as jgl
from audio_diffusion_tpu.ops import mel_filters as jmf
from audio_diffusion_tpu.ops import stft as jst


def test_filterbank_identical():
    for sr, n_fft, n_mels in ((22050, 2048, 256), (22050, 2048, 32), (16000, 1024, 64)):
        np.testing.assert_array_equal(tmf.mel_filterbank(sr, n_fft, n_mels), jmf.mel_filterbank(sr, n_fft, n_mels))


def test_uint8_db_conversions_bit_equal():
    top_db = 80.0
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(tmf.uint8_to_db(torch.from_numpy(u8), top_db).numpy(),
                                  np.asarray(jmf.uint8_to_db(jnp.asarray(u8), top_db)))
    rng = np.random.default_rng(0)
    db = np.concatenate([rng.uniform(-90.0, 5.0, 4000),
                         np.asarray(jmf.uint8_to_db(jnp.arange(256, dtype=jnp.uint8), top_db))]).astype(np.float32)
    db = db.reshape(-1, 16)
    np.testing.assert_array_equal(tmf.db_to_uint8(torch.from_numpy(db), top_db).numpy(),
                                  np.asarray(jmf.db_to_uint8(jnp.asarray(db), top_db)))
    power = rng.uniform(0.0, 3.0, (2, 16, 16)).astype(np.float32) ** 4
    np.testing.assert_allclose(tmf.power_to_db(torch.from_numpy(power), top_db).numpy(),
                               np.asarray(jmf.power_to_db(jnp.asarray(power), top_db)), atol=1e-4)
    np.testing.assert_allclose(tmf.db_to_power(torch.from_numpy(db)).numpy(),
                               np.asarray(jmf.db_to_power(jnp.asarray(db))), rtol=1e-5)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (400, 160)])
def test_stft_istft_match_jax(n_fft, hop):
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((2, 8 * hop - 1)).astype(np.float32)
    spec_t = tst.stft(torch.from_numpy(audio), n_fft, hop)
    spec_j = np.asarray(jst.stft(jnp.asarray(audio), n_fft, hop))
    assert spec_t.shape == spec_j.shape
    np.testing.assert_allclose(spec_t.numpy(), spec_j, atol=2e-4 * np.abs(spec_j).max())
    rec_t = tst.istft(spec_t, n_fft, hop, length=audio.shape[-1])
    rec_j = np.asarray(jst.istft(jnp.asarray(spec_j), n_fft, hop, length=audio.shape[-1]))
    np.testing.assert_allclose(rec_t.numpy(), rec_j, atol=1e-5)
    np.testing.assert_array_equal(tst.windowed_dft_matrices(n_fft)[0], jst.windowed_dft_matrices(n_fft)[0])


def test_nnls_matches_jax():
    basis = tmf.mel_filterbank(22050, 2048, 32)
    rng = np.random.default_rng(2)
    targets = (rng.uniform(0.0, 1.0, (2, 8, 1025)).astype(np.float32) ** 3) @ basis.T
    got = tgl.nnls(basis, torch.from_numpy(targets), n_iter=80).numpy()
    want = np.asarray(jgl.nnls(basis, jnp.asarray(targets), n_iter=80))
    # f32 matmuls sum in other orders; 80 momentum iterations carry that drift
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("projection", ["fft", "matmul"])
def test_griffin_lim_matches_jax_with_shared_phase(projection):
    rng = np.random.default_rng(3)
    mag = rng.uniform(0.0, 1.0, (2, 16, 1025)).astype(np.float32) ** 2
    key = jax.random.key(5)
    phase = np.asarray(2.0 * jnp.pi * jax.random.uniform(key, mag.shape))  # griffin_lim.py:121
    length = 15 * 512
    want = np.asarray(jgl.griffin_lim(jnp.asarray(mag), key, 2048, 512, n_iter=8, length=length,
                                      projection=projection))
    got = tgl.griffin_lim(torch.from_numpy(mag), torch.from_numpy(phase), None, 2048, 512, n_iter=8,
                          length=length, projection=projection).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_mel_roundtrip_mae_within_bench_bound():
    """The bench.py:196-214 probe against the port at 256x256, hop 512."""
    mel = Mel(x_res=256, y_res=256, hop_length=512, device="cpu")
    rng = np.random.default_rng(0)
    t = np.arange(mel.slice_size) / mel.get_sample_rate()
    audio = sum(np.sin(2 * np.pi * f * t) * a for f, a in ((220.0, 0.5), (587.33, 0.3), (1760.0, 0.2)))
    audio = (audio + 0.1 * rng.standard_normal(mel.slice_size)).astype(np.float32)
    img = mel.spectrogram_images_from_audio(audio[None])
    assert img.dtype == torch.uint8 and tuple(img.shape) == (1, 256, 256)
    rec = mel.images_to_audio(img)[0]
    img2 = mel.spectrogram_images_from_audio(torch.nn.functional.pad(rec, (0, mel.slice_size - rec.shape[0]))[None])
    mae = (img.float() - img2.float()).abs().mean().item()
    assert mae < 2.41 + 1.1, mae


def test_mel_defaults_to_the_card_and_raises_without_cuda(monkeypatch):
    """The port's entry points run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mel()
    assert Mel(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("ref", [None, 5.0, np.max, np.mean], ids=["max", "scalar", "np.max", "np.mean"])
def test_mel_slice_api_matches_jax(ref, tmp_path):
    """load_audio (zero-pads short audio), the slice API and the ``ref``
    forms of audio_slice_to_image, against the JAX Mel: uint8 within 1 on at
    most 0.5% of the pixels; config files read and written across packages."""
    from audio_diffusion_tpu.mel import Mel as JaxMel

    jmel, tmel = JaxMel(x_res=32, y_res=64, n_iter=4), Mel(x_res=32, y_res=64, n_iter=4, device="cpu")
    rng = np.random.default_rng(4)
    audio = (0.3 * np.sin(np.arange(3 * 32 * 512 + 100) * 0.03) + 0.05 * rng.standard_normal(3 * 32 * 512 + 100))
    for mel in (jmel, tmel):
        mel.load_audio(raw_audio=audio.astype(np.float32))
    assert tmel.get_number_of_slices() == jmel.get_number_of_slices() == 3
    for s in (0, 2):
        np.testing.assert_array_equal(tmel.get_audio_slice(s), jmel.get_audio_slice(s))
        want = np.asarray(jmel.audio_slice_to_image(s, ref=ref))
        got = np.asarray(tmel.audio_slice_to_image(s, ref=ref))
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert got.shape == (64, 32) and diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), diff.mean())
    short = np.ones(100, np.float32)
    tmel.load_audio(raw_audio=short)
    assert len(tmel.audio) == 32 * 512 and tmel.get_number_of_slices() == 1
    assert tmel.image_to_audio(tmel.audio_slice_to_image(0)).shape == (31 * 512,)

    tmel.set_resolution(16, 16)
    assert (tmel.x_res, tmel.y_res, tmel.slice_size, tmel.config.x_res) == (16, 16, 16 * 512 - 1, 16)
    tmel.save_pretrained(str(tmp_path / "torch"))
    jmel.save_pretrained(str(tmp_path / "jax"))
    assert JaxMel.from_pretrained(str(tmp_path / "torch")).config == JaxMel(x_res=16, y_res=16, n_iter=4).config
    assert Mel.from_pretrained(str(tmp_path / "jax"), device="cpu").config.y_res == 64


def test_audio_io_matches_jax(tmp_path):
    """The port's copy of ops/audio_io.py and apps.wav_bytes: WAV round trip,
    polyphase resampling and the served WAV bytes, against the JAX package's."""
    from audio_diffusion_torch.ops import audio_io
    from audio_diffusion_tpu.apps import wav_bytes as jax_wav_bytes
    from audio_diffusion_tpu.ops import audio_io as jax_audio_io

    rng = np.random.default_rng(5)
    stereo = (0.5 * rng.uniform(-1, 1, (2, 4410))).astype(np.float32)
    path = str(tmp_path / "x.wav")
    audio_io.write_wav(path, stereo, 44100)
    mono = audio_io.load_audio(path, 22050)
    assert mono.shape == (2205,) and mono.dtype == np.float32
    np.testing.assert_allclose(mono, audio_io.resample(stereo.mean(0, keepdims=True), 44100, 22050)[0], atol=1e-3)
    np.testing.assert_array_equal(audio_io.resample(stereo, 44100, 22050), jax_audio_io.resample(stereo, 44100, 22050))
    np.testing.assert_array_equal(audio_io.normalize(stereo[0]), jax_audio_io.normalize(stereo[0]))
    pcm = (stereo[0] * 30000).astype(np.int16)
    for a in (stereo[0], pcm):
        assert audio_io.wav_bytes(a, 22050) == jax_wav_bytes(a, 22050)
    with pytest.raises(ValueError, match="mono=False"):
        audio_io.load_audio(str(tmp_path / "x.mp3"), mono=False)
