"""Batched audio <-> mel-spectrogram-image conversion on a torch device
(port of ``audio_diffusion_tpu/mel.py``).

Forward: STFT -> |.|^2 -> mel matmul -> dB -> uint8. Inverse: uint8 -> dB ->
power -> NNLS -> Griffin-Lim. The uint8 image is the models' data contract and
its quantization matches the JAX package bit for bit. The Griffin-Lim
windowed-DFT matrices are made once per ``Mel`` and kept on its device.

The reference's per-slice API (``load_audio``, ``get_number_of_slices``,
``get_audio_slice``, ``audio_slice_to_image``, ``image_to_audio``,
``set_resolution``) sits on top of the batched methods
(``spectrogram_images_from_audio``, ``images_to_audio``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from PIL import Image

from .ops import audio_io
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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Mel: CUDA device requested but torch.cuda is not available; "
                               "pass device='cpu' to run on the CPU")
        self.config = MelConfig(x_res, y_res, sample_rate, n_fft, hop_length, top_db, n_iter)
        self.sr = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.top_db = top_db
        self.n_iter = n_iter
        self.audio: Optional[np.ndarray] = None
        self._gl_mats = None
        self.set_resolution(x_res, y_res)

    # ------------------------------------------------------------------ config
    @classmethod
    def from_config(cls, config: dict, device: torch.device | str = "cuda") -> "Mel":
        cfg = MelConfig.from_config(config)
        return cls(cfg.x_res, cfg.y_res, cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.top_db, cfg.n_iter,
                   device=device)

    @classmethod
    def from_pretrained(cls, directory: str, device: torch.device | str = "cuda") -> "Mel":
        return cls.from_config(MelConfig.load_config(directory), device=device)

    def save_pretrained(self, directory: str) -> None:
        self.config.save_config(directory)

    # ----------------------------------------------------------- reference API
    def set_resolution(self, x_res: int, y_res: int) -> None:
        """``slice_size`` carries the -1 that makes the centered STFT give exactly x_res frames."""
        self.x_res, self.y_res = x_res, y_res
        self.n_mels = y_res
        self.slice_size = x_res * self.hop_length - 1
        self.config = dataclasses.replace(self.config, x_res=x_res, y_res=y_res)
        self.mel_basis = mel_filterbank(self.sr, self.n_fft, self.n_mels)  # numpy (n_mels, n_freq)
        self._basis_t = torch.as_tensor(self.mel_basis, device=self.device)

    def load_audio(self, audio_file: str = None, raw_audio: np.ndarray = None) -> None:
        """Decode ``audio_file`` (or take ``raw_audio``) at this Mel's rate;
        audio shorter than one slice is zero-padded to ``x_res * hop``."""
        if audio_file is not None:
            self.audio = audio_io.load_audio(audio_file, self.sr)
        else:
            self.audio = np.asarray(raw_audio, dtype=np.float32)
        if len(self.audio) < self.x_res * self.hop_length:
            pad = self.x_res * self.hop_length - len(self.audio)
            self.audio = np.concatenate([self.audio, np.zeros((pad,), dtype=self.audio.dtype)])

    def get_number_of_slices(self) -> int:
        return len(self.audio) // self.slice_size

    def get_audio_slice(self, slice: int = 0) -> np.ndarray:
        return self.audio[self.slice_size * slice : self.slice_size * (slice + 1)]

    def get_sample_rate(self) -> int:
        return self.sr

    def audio_slice_to_image(self, slice: int, ref=None) -> Image.Image:
        """slice -> uint8 mel image. ``ref``: None (per-spectrogram max), a
        scalar, or a callable applied to the power spectrogram as a numpy
        array (librosa's ``ref``); see :func:`.ops.mel_filters.power_to_db`."""
        arr = self.spectrogram_images_from_audio(self.get_audio_slice(slice)[None], ref=ref)[0]
        return Image.fromarray(arr.cpu().numpy())

    def image_to_audio(self, image: Image.Image, generator: torch.Generator | None = None,
                       phase: torch.Tensor | None = None) -> np.ndarray:
        bytedata = np.frombuffer(image.tobytes(), dtype="uint8").reshape((image.height, image.width))
        return self.images_to_audio(bytedata[None].copy(), generator=generator, phase=phase)[0].cpu().numpy()

    # ------------------------------------------------------------- batched API
    def gl_matrices(self) -> tuple:
        """The four windowed-DFT matrices for the matmul Griffin-Lim
        projection, made once and kept on this Mel's device."""
        if self._gl_mats is None:
            self._gl_mats = tuple(torch.as_tensor(m, device=self.device)
                                  for m in windowed_dft_matrices(self.n_fft))
        return self._gl_mats

    def spectrogram_images_from_audio(self, audio, ref=None) -> torch.Tensor:
        """(B, slice_size) audio -> (B, y_res, x_res) uint8 images. ``ref``: see
        :meth:`audio_slice_to_image`."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        spec = stft(audio, self.n_fft, self.hop_length)  # (B, frames, freq)
        power = spec.abs() ** 2
        mel = (power @ self._basis_t.T).transpose(-2, -1)  # image layout (B, n_mels, frames)
        return db_to_uint8(power_to_db(mel, float(self.top_db), ref=ref), float(self.top_db))

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
