"""User-facing convenience API (port of ``audio_diffusion_tpu/audio_diffusion.py``).

``AudioDiffusion`` wraps an :class:`AudioDiffusionPipeline` loaded from a
diffusers-layout directory, or a Hub id that the local HF cache holds
(utils/hub.py). ``loop_it`` beat-tracks generated audio and tiles whole bars
with the reference's bar arithmetic, ``beats_in_bar = (len(beats) - 1) // 4 * 4``.

The JAX ``key``/``step_key`` become ``generator``/``step_generator``
(``torch.Generator``). The model runs on ``device``, the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from .ops.beat import beat_track
from .pipelines.pipeline import AudioDiffusionPipeline


class AudioDiffusion:
    def __init__(self, model_id: str = "teticio/audio-diffusion-256", progress_bar=None, dtype: Optional[str] = None,
                 fused_groupnorm: Optional[bool] = None, device: torch.device | str = "cuda"):
        """Args:
            model_id: local diffusers-layout directory, or a Hub model id like
                ``teticio/audio-diffusion-256`` resolved from the local HF cache.
            dtype: "float32" | "bfloat16", the compute dtype of the UNet and VAE.
            fused_groupnorm: True routes every ResnetBlock2D norm through the
                GroupNorm+SiLU kernel; the diffusers config does not carry it,
                so a loaded model takes torch's GroupNorm without it.
            device: "cuda" (default) or "cpu".
        """
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AudioDiffusion: CUDA device requested but torch.cuda is not available; "
                               "pass device='cpu' to run on the CPU")
        self.model_id = model_id
        self.pipe = AudioDiffusionPipeline.from_pretrained(model_id, dtype=dtype, fused_groupnorm=fused_groupnorm,
                                                           device=device)

    def generate_spectrogram_and_audio(
        self,
        steps: int = None,
        generator: Optional[torch.Generator] = None,
        step_generator: Optional[torch.Generator] = None,
        eta: float = 0,
        noise=None,
        encoding=None,
    ) -> Tuple[Image.Image, Tuple[int, np.ndarray]]:
        """Random mel spectrogram + audio (reference: __init__.py:35-68)."""
        images, (sample_rate, audios) = self.pipe(
            batch_size=1, steps=steps, generator=generator, step_generator=step_generator,
            eta=eta, noise=noise, encoding=encoding, return_dict=False,
        )
        return images[0], (sample_rate, audios[0])

    def generate_spectrogram_and_audio_from_audio(
        self,
        audio_file: str = None,
        raw_audio: np.ndarray = None,
        slice: int = 0,
        start_step: int = 0,
        steps: int = None,
        generator: Optional[torch.Generator] = None,
        mask_start_secs: float = 0,
        mask_end_secs: float = 0,
        step_generator: Optional[torch.Generator] = None,
        eta: float = 0,
        encoding=None,
        noise=None,
    ) -> Tuple[Image.Image, Tuple[int, np.ndarray]]:
        """Conditioned on input audio (reference: __init__.py:70-122)."""
        images, (sample_rate, audios) = self.pipe(
            batch_size=1, audio_file=audio_file, raw_audio=raw_audio, slice=slice,
            start_step=start_step, steps=steps, generator=generator,
            mask_start_secs=mask_start_secs, mask_end_secs=mask_end_secs,
            step_generator=step_generator, eta=eta, noise=noise, encoding=encoding,
            return_dict=False,
        )
        return images[0], (sample_rate, audios[0])

    @staticmethod
    def loop_it(audio: np.ndarray, sample_rate: int, loops: int = 12) -> Optional[np.ndarray]:
        """Tile whole bars of audio, or None if no bar is found
        (reference: __init__.py:124-140, beats_in_bar = (len(beats)-1)//4*4)."""
        _, beats = beat_track(np.asarray(audio), sample_rate, units="samples")
        beats_in_bar = (len(beats) - 1) // 4 * 4
        if beats_in_bar > 0:
            return np.tile(audio[beats[0] : beats[beats_in_bar]], loops)
        return None
