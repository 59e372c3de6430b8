"""Slaney mel filterbank and dB conversions (port of ``audio_diffusion_tpu/ops/mel_filters.py``).

The filterbank is numpy, copied as it is, so both packages use the identical
matrix. The uint8 conversions are the models' data contract and match the
JAX package bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Slaney auditory-toolbox mel scale constants.
_F_SP = 200.0 / 3.0  # Hz per mel below the break
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0

AMIN = 1e-10  # librosa power_to_db amin default


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    f = np.asarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mels = np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP, mels)
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    m = np.asarray(mels, dtype=np.float64)
    freqs = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    freqs = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(m, _MIN_LOG_MEL) - _MIN_LOG_MEL)), freqs)
    return freqs


@lru_cache(maxsize=16)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, shape (n_mels, n_fft//2 + 1)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)

    mel_pts = np.linspace(hz_to_mel(np.array(fmin)), hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~2/bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def power_to_db(S: torch.Tensor, top_db: float = 80.0, ref=None) -> torch.Tensor:
    """librosa ``power_to_db(S, ref, top_db)`` over the trailing 2 axes.

    ``ref=None`` means ``ref=np.max``: relative to each spectrogram's
    maximum, so the output peaks at 0 dB and floors at ``-top_db``. A scalar
    shifts by ``10*log10(|ref|)``. A callable is applied to each
    spectrogram's power matrix, handed to it as a numpy array on the host as
    librosa does, and ``|ref(S)|`` is the reference; the result floors at
    ``max - top_db`` in every case."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=AMIN))
    if ref is None:
        ref_db = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    elif callable(ref):
        flat = S.detach().reshape((-1,) + tuple(S.shape[-2:])).cpu().numpy()
        ref_val = torch.tensor([float(np.abs(ref(s))) for s in flat], dtype=torch.float32, device=S.device)
        ref_db = 10.0 * torch.log10(torch.clamp(ref_val.reshape(S.shape[:-2] + (1, 1)), min=AMIN))
    else:
        ref_db = 10.0 * torch.log10(torch.clamp(torch.tensor(abs(float(ref)), dtype=torch.float32), min=AMIN))
    log_spec = log_spec - ref_db.to(log_spec.device)
    peak = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    return torch.maximum(log_spec, peak - top_db)


def db_to_power(S_db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, 0.1 * S_db)


def db_to_uint8(log_S: torch.Tensor, top_db: float) -> torch.Tensor:
    """Reference quantization: ``+0.5`` then truncate, bit for bit."""
    bytedata = torch.clamp((log_S + top_db) * 255.0 / top_db, 0.0, 255.0) + 0.5
    return bytedata.to(torch.uint8)


def uint8_to_db(bytedata: torch.Tensor, top_db: float) -> torch.Tensor:
    """Reference dequantization, bit for bit."""
    return bytedata.to(torch.float32) * top_db / 255.0 - top_db
