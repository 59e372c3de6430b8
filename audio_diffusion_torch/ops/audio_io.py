"""Host-side audio I/O: decode, resample, WAV writing and WAV bytes (a copy of
``audio_diffusion_tpu/ops/audio_io.py`` and ``apps.py::wav_bytes``).

numpy, scipy and the stdlib ``wave`` only. WAV decodes with scipy; other
formats go through an ``ffmpeg`` binary when one is on the PATH and raise a
clear error otherwise. The JAX package's native C++ decoder is not used here.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from io import BytesIO
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly


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
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio(path: str, sample_rate: int = 22050, mono: bool = True) -> np.ndarray:
    """Decode an audio file to float32 mono at ``sample_rate`` (librosa.load parity)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        audio, sr = _read_wav(path)
    else:
        if not mono:
            raise ValueError("compressed formats decode with a mono downmix; "
                             "mono=False is only supported for WAV files")
        if not shutil.which("ffmpeg"):
            raise ValueError(f"Cannot decode {path!r}: no ffmpeg binary was found. Install ffmpeg or convert "
                             "the file to WAV.")
        audio, sr = _read_via_ffmpeg(path, sample_rate)
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
