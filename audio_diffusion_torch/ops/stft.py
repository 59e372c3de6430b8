"""Batched STFT / ISTFT in PyTorch, librosa conventions (port of ``audio_diffusion_tpu/ops/stft.py``).

``center=True`` pads with ZEROS (librosa ``pad_mode="constant"``), unlike
``torch.stft(center=True)``, which reflects, so framing is done here with
``F.pad(mode="constant")`` and ``unfold``. Periodic Hann window,
``win_length == n_fft``, one-sided FFT, squared-window-sum normalization in
the inverse with librosa's tiny-threshold guard. Spectrograms are
frames-major: (..., n_frames, n_fft // 2 + 1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, identical to scipy ``get_window('hann', n, fftbins=True)``."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


def num_frames(num_samples: int, n_fft: int, hop_length: int) -> int:
    """Number of STFT frames for a centered transform of ``num_samples`` samples."""
    return 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def frame(audio: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Zero-center-pad and frame a batch of signals: (..., T) -> (..., n_frames, n_fft)."""
    pad = n_fft // 2
    x = F.pad(audio, (pad, pad), mode="constant", value=0.0)
    return x.unfold(-1, n_fft, hop_length)


def stft(audio: torch.Tensor, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """(..., T) real -> (..., n_frames, n_fft // 2 + 1) complex64."""
    window = _hann_tensor(n_fft, audio.device).to(audio.dtype)
    return torch.fft.rfft(frame(audio, n_fft, hop_length) * window, dim=-1)


@lru_cache(maxsize=16)
def _hann_tensor(n_fft: int, device: torch.device) -> torch.Tensor:
    """The f32 Hann window, made once per device (a host-to-device copy of
    pageable memory would otherwise stall the stream on every call)."""
    return torch.as_tensor(hann_window(n_fft), dtype=torch.float32, device=device)


@lru_cache(maxsize=16)
def _inv_window_sumsquare(n_frames: int, n_fft: int, hop_length: int, device: torch.device) -> torch.Tensor:
    """1 / sum of squared Hann windows (librosa window_sumsquare with its tiny
    guard), f32 on ``device``, made once per geometry."""
    full = (n_frames - 1) * hop_length + n_fft
    wss = np.zeros((full,), dtype=np.float64)
    w2 = hann_window(n_fft) ** 2
    for s in range(0, n_frames * hop_length, hop_length):
        wss[s : s + n_fft] += w2
    tiny = np.finfo(np.float32).tiny
    inv = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0).astype(np.float32)
    return torch.as_tensor(inv, device=device)


def overlap_add_normalize(frames: torch.Tensor, hop_length: int, length: int | None = None) -> torch.Tensor:
    """Windowed ISTFT frames (..., n_frames, n_fft) -> signal (..., length):
    overlap-add, squared-window-sum normalization, center-crop. Shared by
    :func:`istft` and the DFT-matmul Griffin-Lim projection."""
    n_frames, n_fft = frames.shape[-2], frames.shape[-1]
    pad = n_fft // 2
    full = (n_frames - 1) * hop_length + n_fft
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft)
    if n_fft % hop_length == 0:
        # R shifted adds of contiguous hop-chunks: frame f's chunk r lands at chunk f + r.
        r_factor = n_fft // hop_length
        chunked = flat.reshape(flat.shape[0], n_frames, r_factor, hop_length)
        acc = torch.zeros((flat.shape[0], n_frames + r_factor - 1, hop_length),
                          dtype=frames.dtype, device=frames.device)
        for r in range(r_factor):
            acc[:, r : r + n_frames, :] += chunked[:, :, r, :]
        out = acc.reshape(flat.shape[0], -1)[:, :full]
    else:
        starts = torch.arange(n_frames, device=frames.device) * hop_length
        idx = (starts[:, None] + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
        out = torch.zeros((flat.shape[0], full), dtype=frames.dtype, device=frames.device)
        out.index_add_(1, idx, flat.reshape(flat.shape[0], -1))

    out = out * _inv_window_sumsquare(n_frames, n_fft, hop_length, frames.device)
    if length is None:
        length = (n_frames - 1) * hop_length
    return out[:, pad : pad + length].reshape(batch_shape + (length,))


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 512, length: int | None = None) -> torch.Tensor:
    """(..., n_frames, n_fft // 2 + 1) complex -> (..., length) real."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * _hann_tensor(n_fft, spec.device)
    return overlap_add_normalize(frames, hop_length, length=length)


@lru_cache(maxsize=8)
def windowed_dft_matrices(n_fft: int) -> tuple:
    """Real one-sided DFT synthesis/analysis matrices with the periodic Hann
    window folded in (numpy f32): for a one-sided spectrum (r, i),
    ``r @ IRr + i @ IRi == irfft(r + 1j*i, n_fft) * hann``; for time frames x,
    ``x @ FWr + 1j * (x @ FWi) == rfft(x * hann)``. Returns (IRr, IRi, FWr, FWi)."""
    k = np.arange(n_fft)
    f = np.arange(n_fft // 2 + 1)
    W = np.exp(2j * np.pi * np.outer(f, k) / n_fft)  # (n_freq, n_fft)
    # irfft doubles every bin except DC and (for even n) Nyquist.
    dbl = np.where((f == 0) | (f == n_fft // 2), 1.0, 2.0)[:, None]
    w = hann_window(n_fft)
    ir_r = (np.real(W) * dbl / n_fft * w).astype(np.float32)
    ir_i = (-np.imag(W) * dbl / n_fft * w).astype(np.float32)
    fw_r = (np.real(W) * w).T.astype(np.float32)
    fw_i = (-np.imag(W) * w).T.astype(np.float32)
    return ir_r, ir_i, fw_r, fw_i
