"""Beat tracking for loop extraction (a copy of ``audio_diffusion_tpu/ops/beat.py``).

numpy on the host, as in the JAX package: onset-strength envelope -> tempo
estimate via prior-weighted autocorrelation -> dynamic-programming beat picker
(Ellis 2007, the algorithm ``librosa.beat.beat_track`` implements). The
envelope is a few thousand frames, too small to pay for a trip to the device.
It uses the port's own filterbank and window, which are the JAX package's
arrays, so the beats are the same bit for bit.
"""

from __future__ import annotations

import numpy as np

from .mel_filters import mel_filterbank
from .stft import hann_window


def onset_strength(audio: np.ndarray, sr: int, hop_length: int = 512, n_fft: int = 2048,
                   n_mels: int = 128) -> np.ndarray:
    """Spectral-flux onset envelope on a log-mel spectrogram."""
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = x[idx] * hann_window(n_fft)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # (frames, freq)
    mel = spec @ mel_filterbank(sr, n_fft, n_mels).T.astype(np.float64)
    log_mel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 80.0)
    flux = np.maximum(0.0, np.diff(log_mel, axis=0))  # half-wave rectified
    env = flux.mean(axis=1)
    return np.concatenate([[0.0], env])


def estimate_tempo(onset_env: np.ndarray, sr: int, hop_length: int = 512,
                   start_bpm: float = 120.0, std_bpm: float = 1.0) -> float:
    """Tempo (BPM) from the onset autocorrelation with a log-normal prior."""
    n = len(onset_env)
    env = onset_env - onset_env.mean()
    ac = np.correlate(env, env, mode="full")[n - 1 :]
    ac = np.maximum(ac, 0.0)

    frames_per_sec = sr / hop_length
    lags = np.arange(1, min(n, int(frames_per_sec * 4)))  # down to 15 BPM
    bpms = 60.0 * frames_per_sec / lags
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    scores = ac[lags] * prior
    if scores.size == 0 or scores.max() <= 0:
        return start_bpm
    return float(bpms[np.argmax(scores)])


def beat_track(audio: np.ndarray, sr: int, hop_length: int = 512,
               tightness: float = 100.0, units: str = "samples") -> tuple:
    """(tempo_bpm, beat positions). DP beat picker over the onset envelope."""
    env = onset_strength(audio, sr, hop_length)
    if env.max() <= 0:
        return 0.0, np.array([], dtype=int)
    tempo = estimate_tempo(env, sr, hop_length)
    period = (60.0 * sr / hop_length) / tempo  # frames per beat

    # Normalize envelope (librosa standardizes by its std).
    std = env.std()
    norm_env = env / (std if std > 0 else 1.0)

    n = len(norm_env)
    lo, hi = max(1, int(round(period / 2))), min(n - 1, int(round(period * 2)))
    backlink = np.full(n, -1, dtype=int)
    cumscore = norm_env.copy()
    for i in range(lo, n):
        prev_lo, prev_hi = max(0, i - hi), i - lo + 1
        window = np.arange(prev_lo, prev_hi)
        if window.size == 0:
            continue
        txcost = -tightness * (np.log(np.maximum(i - window, 1) / period)) ** 2
        candidates = cumscore[window] + txcost
        best = np.argmax(candidates)
        if candidates[best] > 0:
            cumscore[i] = norm_env[i] + candidates[best]
            backlink[i] = window[best]

    # Backtrace from the best scoring position in the final beat period.
    tail = cumscore[-int(round(period)):]
    start = n - len(tail) + int(np.argmax(tail))
    beats = [start]
    while backlink[beats[-1]] >= 0:
        beats.append(backlink[beats[-1]])
    beats = np.array(beats[::-1], dtype=int)

    if units == "samples":
        return tempo, beats * hop_length
    if units == "frames":
        return tempo, beats
    if units == "time":
        return tempo, beats * hop_length / sr
    raise ValueError(f"unknown units {units!r}")
