"""Batched audio <-> mel-spectrogram-image conversion on a torch device
(port of ``audio_diffusion_tpu/mel.py``, generation-path subset).

Forward: STFT -> |.|^2 -> mel matmul -> dB -> uint8. Inverse: uint8 -> dB ->
power -> NNLS -> Griffin-Lim. The uint8 image is the models' data contract and
its quantization matches the JAX package bit for bit. The Griffin-Lim
windowed-DFT matrices are made once per ``Mel`` and kept on its device.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.griffin_lim import mel_to_audio
from .ops.mel_filters import db_to_power, db_to_uint8, mel_filterbank, power_to_db, uint8_to_db
from .ops.stft import stft, windowed_dft_matrices
from .utils.config import ConfigMixin


@dataclasses.dataclass(frozen=True)
class MelConfig(ConfigMixin):
    """Serialized as ``mel_config.json``; the same fields and file as the JAX package's."""

    x_res: int = 256
    y_res: int = 256
    sample_rate: int = 22050
    n_fft: int = 2048
    hop_length: int = 512
    top_db: int = 80
    n_iter: int = 32

    config_name = "mel_config.json"


class Mel:
    def __init__(
        self,
        x_res: int = 256,
        y_res: int = 256,
        sample_rate: int = 22050,
        n_fft: int = 2048,
        hop_length: int = 512,
        top_db: int = 80,
        n_iter: int = 32,
        device: torch.device | str = "cuda",
    ):
        self.config = MelConfig(x_res, y_res, sample_rate, n_fft, hop_length, top_db, n_iter)
        self.x_res, self.y_res = x_res, y_res
        self.n_mels = y_res
        self.sr = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.top_db = top_db
        self.n_iter = n_iter
        # slice_size carries the -1 that makes the centered STFT give exactly x_res frames.
        self.slice_size = x_res * hop_length - 1
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Mel: CUDA device requested but torch.cuda is not available; "
                               "pass device='cpu' to run on the CPU")
        self.mel_basis = mel_filterbank(sample_rate, n_fft, self.n_mels)  # numpy (n_mels, n_freq)
        self._basis_t = torch.as_tensor(self.mel_basis, device=self.device)
        self._gl_mats = None

    def get_sample_rate(self) -> int:
        return self.sr

    def gl_matrices(self) -> tuple:
        """The four windowed-DFT matrices for the matmul Griffin-Lim
        projection, made once and kept on this Mel's device."""
        if self._gl_mats is None:
            self._gl_mats = tuple(torch.as_tensor(m, device=self.device)
                                  for m in windowed_dft_matrices(self.n_fft))
        return self._gl_mats

    def spectrogram_images_from_audio(self, audio) -> torch.Tensor:
        """(B, slice_size) audio -> (B, y_res, x_res) uint8 images, dB relative
        to each spectrogram's maximum."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        spec = stft(audio, self.n_fft, self.hop_length)  # (B, frames, freq)
        power = spec.abs() ** 2
        mel = (power @ self._basis_t.T).transpose(-2, -1)  # image layout (B, n_mels, frames)
        return db_to_uint8(power_to_db(mel, float(self.top_db)), float(self.top_db))

    def images_to_audio(self, images, generator: torch.Generator | None = None,
                        phase: torch.Tensor | None = None, projection: str = "fft") -> torch.Tensor:
        """(B, y_res, x_res) uint8 images -> (B, (x_res - 1) * hop) f32 audio.

        The random initial Griffin-Lim phase comes from ``generator`` (a fresh
        seed-0 generator when None, for reproducibility) unless ``phase``
        (B, x_res, n_fft // 2 + 1) radians is handed in. ``projection``: see
        :func:`.ops.griffin_lim.griffin_lim`."""
        images = torch.as_tensor(images, device=self.device)
        if tuple(images.shape[-2:]) != (self.y_res, self.x_res):
            raise ValueError(f"expected (..., {self.y_res}, {self.x_res}) mel images for this Mel config, "
                             f"got {tuple(images.shape)}; construct a Mel with matching x_res/y_res")
        if phase is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        log_s = uint8_to_db(images, float(self.top_db))
        mel_power = db_to_power(log_s).transpose(-2, -1)  # (B, frames, n_mels)
        length = (self.x_res - 1) * self.hop_length
        return mel_to_audio(mel_power, self.mel_basis, phase, generator, self.n_fft, self.hop_length,
                            self.n_iter, length=length, projection=projection,
                            dft_mats=self.gl_matrices() if projection == "matmul" else None)
