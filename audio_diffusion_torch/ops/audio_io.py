"""Host-side audio I/O: decode, resample, WAV writing and WAV bytes (a copy of
``audio_diffusion_tpu/ops/audio_io.py`` and ``apps.py::wav_bytes``).

Decoding goes the JAX package's way: a mono WAV through the native C++
decoder and resampler (``data/native_audio.py``) when it builds, else scipy;
mp3/m4a through the native media decoder, else an ``ffmpeg`` binary, else a
clear error. :func:`decoder_for` names the decoder a file would take.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from io import BytesIO
from typing import Tuple

import numpy as np


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV into float32 in [-1, 1], shape (channels, T)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    else:
        audio = audio.T
    return audio, int(sr)


def _read_via_ffmpeg(path: str, sample_rate: int) -> Tuple[np.ndarray, int]:
    cmd = [
        "ffmpeg", "-v", "error", "-i", path,
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sample_rate), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    audio = np.frombuffer(out, dtype=np.float32)
    return audio[None, :], sample_rate


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly  # imported here: scipy.signal takes seconds to import

    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def decoder_for(path: str) -> str:
    """Which decoder :func:`load_audio` takes for ``path`` (mono): "native",
    "scipy", "native-media", "ffmpeg" or "none"."""
    from ..data import native_audio

    if os.path.splitext(path)[1].lower() == ".wav":
        return "native" if native_audio.available() else "scipy"
    if native_audio.media_available():
        return "native-media"
    return "ffmpeg" if shutil.which("ffmpeg") else "none"


def load_audio(path: str, sample_rate: int = 22050, mono: bool = True) -> np.ndarray:
    """Decode an audio file to float32 mono at ``sample_rate`` (librosa.load parity).

    Uses the native C++ decoder+resampler (native/audioio.cpp) when built;
    falls back to scipy otherwise.
    """
    from ..data import native_audio

    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav" and mono:
        native = native_audio.load_wav(path, sample_rate)
        if native is not None:
            return native
    if ext == ".wav":
        audio, sr = _read_wav(path)
    else:
        if not mono:
            raise ValueError("compressed formats decode with a mono downmix; "
                             "mono=False is only supported for WAV files")
        decoded = native_audio.load_media(path, sample_rate)
        if decoded is not None:
            return decoded
        if shutil.which("ffmpeg"):
            audio, sr = _read_via_ffmpeg(path, sample_rate)
        else:
            raise ValueError(
                f"Cannot decode {path!r}: the native media decoder "
                "(native/mediadec.cpp, needs the system libavformat/libavcodec) "
                "could not be built and no ffmpeg binary was found. Install the "
                "ffmpeg libraries or convert to WAV."
            )
    if mono and audio.shape[0] > 1:
        audio = audio.mean(axis=0, keepdims=True)
    audio = resample(audio, sr, sample_rate)
    return audio[0] if mono else audio


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono/stereo float audio as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as fh:
        fh.setnchannels(pcm.shape[0])
        fh.setsampwidth(2)
        fh.setframerate(sample_rate)
        fh.writeframes(pcm.T.tobytes())


def normalize(audio: np.ndarray) -> np.ndarray:
    """Peak-normalize (librosa.util.normalize default)."""
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """Peak-normalized 16-bit mono WAV bytes. int16 input (the serving pcm16
    path, already quantized on the device) passes through untouched, so the
    wav and raw-PCM deliveries carry identical samples."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        pcm = np.ascontiguousarray(audio)
    else:
        pcm = np.clip(normalize(audio) * 32767.0, -32768, 32767).astype(np.int16)
    buf = BytesIO()
    with wave.open(buf, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(sample_rate)
        fh.writeframes(pcm.tobytes())
    return buf.getvalue()
