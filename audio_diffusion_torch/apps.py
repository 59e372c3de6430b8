"""UI-independent app logic (port of ``audio_diffusion_tpu/apps.py``).

The logic of the reference's gradio and streamlit callbacks (reference:
app.py:26-43, streamlit_app.py:30-45), testable without either UI installed.
``wav_bytes`` is the port's ``ops/audio_io.wav_bytes``, re-exported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .audio_diffusion import AudioDiffusion
from .ops.audio_io import wav_bytes  # noqa: F401

# The published model ids (Hugging Face Hub). They resolve from the local HF
# cache only (utils/hub.py): download each repository elsewhere, or pass
# local paths.
MODELS = [
    "teticio/audio-diffusion-256",
    "teticio/audio-diffusion-breaks-256",
    "teticio/audio-diffusion-instrumental-hiphop-256",
    "teticio/audio-diffusion-ddim-256",
    "teticio/latent-audio-diffusion-256",
    "teticio/latent-audio-diffusion-ddim-256",
]

_cache: Dict[Tuple[str, str], AudioDiffusion] = {}


def get_model(model_id: str, factory=AudioDiffusion, device: torch.device | str = "cuda") -> AudioDiffusion:
    """Per-process model cache, one model per (id, device) (reference: app.py
    caches via a global; streamlit via st.cache_resource). ``factory`` is
    called as ``factory(model_id=..., device=...)``."""
    key = (model_id, str(device))
    if key not in _cache:
        _cache[key] = factory(model_id=model_id, device=device)
    return _cache[key]


def generate_spectrogram_audio_and_loop(model_id: str, factory=AudioDiffusion, device: torch.device | str = "cuda"):
    """The gradio callback (reference: app.py:26-43): generate one sample and
    return (image, (sr, audio), (sr, loop)); the loop falls back to the raw
    audio when beat tracking finds no usable bar structure."""
    audio_diffusion = get_model(model_id, factory, device)
    image, (sample_rate, audio) = audio_diffusion.generate_spectrogram_and_audio()
    loop = AudioDiffusion.loop_it(audio, sample_rate)
    if loop is None:
        loop = audio
    return image, (sample_rate, np.asarray(audio)), (sample_rate, np.asarray(loop))
