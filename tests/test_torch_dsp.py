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
