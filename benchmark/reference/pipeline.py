"""The plain reference of one generation request, in float32 PyTorch and NumPy.

noise -> ``steps`` deterministic DDIM steps (diffusers 0.24 semantics, from
the configuration's ``scheduler``: ``linear`` or ``scaled_linear`` betas,
"leading" spacing plus ``steps_offset``, epsilon prediction, x0 clipped to
[-1, 1] where ``clip_sample``, the final alpha 1 or ``alphas_cumprod[0]`` by
``set_alpha_to_one``) of the UNet -> the
VAE decode of latents / 0.18215 -> uint8 (half-to-even rounding of
(x / 2 + 0.5) * 255) -> the mel inversion of the reference's ``Mel``:
uint8 -> dB -> power, 80 FISTA iterations of non-negative least squares onto
the Slaney mel basis, the square root, 32 momentum (0.99) Griffin-Lim
iterations from a given initial phase, centered zero-padded periodic-Hann
STFTs -> int16 PCM (peak-normalised, truncated toward zero).

Independent of the program under test: written from those definitions
(librosa's and diffusers'), importing nothing of it.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

LATENT_SCALE = 0.18215


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuBLAS and cuDNN while the reference runs, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -------------------------------------------------------------------- DDIM

class DDIM:
    """The deterministic DDIM of a configuration's ``scheduler`` block: its ``alphas_cumprod`` table (float64
    betas, their cumulative product cast to float32), its timesteps and its final alpha."""

    def __init__(self, sched: dict):
        if sched.get("prediction_type", "epsilon") != "epsilon":
            raise ValueError(f"prediction_type {sched['prediction_type']!r}: the reference predicts epsilon")
        t, b0, b1 = sched["num_train_timesteps"], sched["beta_start"], sched["beta_end"]
        kind = sched["beta_schedule"]
        if kind == "linear":
            betas = np.linspace(b0, b1, t, dtype=np.float64)
        elif kind == "scaled_linear":
            betas = np.linspace(b0 ** 0.5, b1 ** 0.5, t, dtype=np.float64) ** 2
        else:
            raise ValueError(f"beta_schedule {kind!r}: the reference has linear and scaled_linear")
        self.num_train = t
        self.alphas = np.cumprod(1.0 - betas).astype(np.float32)
        self.final = 1.0 if sched["set_alpha_to_one"] else float(self.alphas[0])
        self.offset = sched.get("steps_offset", 0)
        self.clip = sched.get("clip_sample", True)

    def timesteps(self, steps: int) -> np.ndarray:
        """"leading" spacing: (arange(steps) * (T // steps)).round(), descending, plus ``steps_offset``."""
        ratio = self.num_train // steps
        return (np.arange(steps) * ratio).round()[::-1].astype(np.int64) + self.offset

    def step(self, eps: torch.Tensor, t: int, x: torch.Tensor, delta: int) -> torch.Tensor:
        a_t = float(self.alphas[t])
        a_prev = float(self.alphas[t - delta]) if t - delta >= 0 else self.final
        x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
        if self.clip:
            x0 = x0.clamp(-1.0, 1.0)
        return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


def denoise(unet, noise: torch.Tensor, steps: int, sched: dict, context=None) -> torch.Tensor:
    """``steps`` DDIM steps of ``unet(x, t, context)`` from ``noise``, under the configuration's ``sched``."""
    ddim = DDIM(sched)
    delta = ddim.num_train // steps
    x = noise.float()
    for t in ddim.timesteps(steps):
        x = ddim.step(unet(x, int(t), context), int(t), x, delta)
    return x


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) model output in [-1, 1] -> (B, H, W) uint8."""
    return torch.round(torch.clamp(x[..., 0] / 2 + 0.5, 0.0, 1.0) * 255).to(torch.uint8)


# ------------------------------------------------------------------ audio

def hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


@lru_cache(maxsize=4)
def slaney_mel_basis(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, htk=False, norm='slaney'), float32 (n_mels, n_fft // 2 + 1)."""
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)

    fft_f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    ramps = hz[:, None] - fft_f[None, :]
    fd = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    return (w * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def _frames(audio, n_fft, hop):
    return F.pad(audio, (n_fft // 2, n_fft // 2)).unfold(-1, n_fft, hop)


def stft(audio, n_fft, hop):
    return torch.fft.rfft(_frames(audio, n_fft, hop) * torch.as_tensor(hann(n_fft), dtype=torch.float32,
                                                                        device=audio.device), dim=-1)


def istft(spec, n_fft, hop, length):
    """Overlap-add of the windowed inverse frames, divided by the summed squared window (librosa's guard)."""
    w = torch.as_tensor(hann(n_fft), dtype=torch.float32, device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w  # (..., T, n_fft)
    n = frames.shape[-2]
    full = (n - 1) * hop + n_fft
    lead = frames.shape[:-2]
    flat = frames.reshape(-1, n, n_fft)
    idx = (torch.arange(n, device=spec.device)[:, None] * hop + torch.arange(n_fft, device=spec.device)).reshape(-1)
    out = torch.zeros((flat.shape[0], full), dtype=frames.dtype, device=spec.device)
    out.index_add_(1, idx, flat.reshape(flat.shape[0], -1))
    wss = np.zeros(full)
    for s in range(0, n * hop, hop):
        wss[s:s + n_fft] += hann(n_fft) ** 2
    tiny = np.finfo(np.float32).tiny
    inv = torch.as_tensor(np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0), dtype=torch.float32,
                          device=spec.device)
    return (out * inv)[:, n_fft // 2:n_fft // 2 + length].reshape(*lead, length)


def _keep(x):
    return x


def _bf16(x):
    """``x`` rounded to bfloat16, back in its own type (a complex tensor part by part)."""
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).to(x.dtype)


ROUND = {"float32": _keep, "bfloat16": _bf16}


def nnls(basis: np.ndarray, target: torch.Tensor, iters: int = 80, q=_keep) -> torch.Tensor:
    """FISTA for min_{x >= 0} ||x basis^T - target||^2, from the clipped pseudo-inverse, step 1 / ||basis||_2^2.
    ``q`` rounds every operand of the products (the control's lower precision)."""
    b64 = basis.astype(np.float64)
    pinv = q(torch.as_tensor(np.linalg.pinv(b64).astype(np.float32), device=target.device))
    lip = float(np.linalg.svd(b64, compute_uv=False)[0] ** 2)
    B = q(torch.as_tensor(basis, device=target.device))
    x = torch.clamp(q(target) @ pinv.T, min=0.0)
    y, t = x, 1.0
    for _ in range(iters):
        x_new = torch.clamp(y - (1.0 / lip) * (q(q(q(y) @ B.T) - target) @ B), min=0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def griffin_lim(mag, phase, n_fft, hop, iters, length, momentum=0.99, q=_keep):
    beta = momentum / (1.0 + momentum)
    angles = torch.polar(torch.ones_like(phase), phase)
    prev = torch.zeros_like(angles)
    for _ in range(iters):
        rebuilt = stft(q(istft(q(mag * angles), n_fft, hop, length)), n_fft, hop)
        angles = rebuilt - beta * prev
        angles = angles / (angles.abs() + 1e-16)
        prev = rebuilt
    return istft(q(mag * angles), n_fft, hop, length)


def pcm16(audio: torch.Tensor) -> torch.Tensor:
    peak = audio.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.clamp(audio / peak * 32767.0, -32768, 32767).to(torch.int16)


def images_to_pcm16(images: torch.Tensor, phase: torch.Tensor, mel: dict, precision: str = "float32"
                    ) -> torch.Tensor:
    """(B, n_mels, frames) uint8 mel images -> (B, (frames - 1) * hop) int16 PCM, from the initial phase
    (B, frames, n_fft // 2 + 1) in radians. ``precision`` "bfloat16" rounds the operands of every product
    and transform to bfloat16: the control of this float32 stage."""
    q = ROUND[precision]
    top_db, n_fft, hop = float(mel.get("top_db", 80)), mel.get("n_fft", 2048), mel["hop_length"]
    db = images.float() * top_db / 255.0 - top_db
    power = torch.pow(10.0, 0.1 * db).transpose(-2, -1)  # (B, frames, n_mels)
    basis = slaney_mel_basis(mel.get("sample_rate", 22050), n_fft, images.shape[-2])
    mag = torch.sqrt(torch.clamp(nnls(basis, power, q=q), min=0.0))
    length = (images.shape[-1] - 1) * hop
    return pcm16(griffin_lim(mag, phase.float(), n_fft, hop, mel.get("n_iter", 32), length, q=q))


@torch.no_grad()
def generate_images(unet, vae, noise, steps: int, sched: dict, context=None, rows_per_block: int = 8
                    ) -> torch.Tensor:
    """uint8 spectrograms of ``noise`` (B, h, w, c), run ``rows_per_block`` rows at a time so that it fits."""
    out = []
    for i in range(0, noise.shape[0], rows_per_block):
        ctx = None if context is None else context[i:i + rows_per_block]
        x = denoise(unet, noise[i:i + rows_per_block], steps, sched, ctx)
        if vae is not None:
            x = vae(x / LATENT_SCALE)
        out.append(to_uint8(x))
    return torch.cat(out)
