"""AudioDiffusionPipeline, pure-generation path (port of ``audio_diffusion_tpu/pipelines/pipeline.py``).

The JAX package compiles generation into one program
(``_fused_generate_fn``, pipeline.py:317-401). Here the same stages run
eagerly on one device, in the same order:

    noise -> DDIM loop of UNet + scheduler step -> [VAE decode of
    latents / LATENT_SCALE] -> uint8 postprocess -> NNLS + Griffin-Lim
    -> [int16 PCM]

Randomness comes from one ``torch.Generator``: first the noise, then the
Griffin-Lim initial phase. torch cannot reproduce ``jax.random``, so the
parity tests inject both (``noise=``, ``gl_phase=``). There is no CPU
fallback: the pipeline runs on the device it is given, and on a CUDA device
every kernel wrapper launches its kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from ..mel import Mel
from ..models.unet2d import UNet2D
from ..schedulers import DDIMScheduler

LATENT_SCALE = 0.18215  # SD latent scaling (pipeline.py:47)


def postprocess_images(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC model output -> (B, H, W) uint8 grayscale: half-to-even
    round to uint8 (``torch.round`` == ``jnp.round``), then for 3-channel
    output PIL's ``convert("L")`` luminance in 16.16 fixed point."""
    x = torch.clamp(x / 2 + 0.5, 0.0, 1.0)
    x = torch.round(x * 255).to(torch.uint8)
    if x.shape[-1] == 1:
        return x[..., 0]
    x32 = x.to(torch.int32)
    lum = (x32[..., 0] * 19595 + x32[..., 1] * 38470 + x32[..., 2] * 7471 + 0x8000) >> 16
    return lum.to(torch.uint8)


def pcm16_quantize(audio: torch.Tensor) -> torch.Tensor:
    """Peak-normalize float audio and quantize to int16 PCM: clip, then
    truncate toward zero."""
    peak = torch.clamp(torch.amax(torch.abs(audio), dim=-1, keepdim=True), min=1e-12)
    return torch.clamp(audio / peak * 32767.0, -32768, 32767).to(torch.int16)


@dataclasses.dataclass
class PipelineOutput:
    images: List[Image.Image]
    sample_rate: int
    audios: List[np.ndarray]
    raw_images: np.ndarray  # (B, H, W) uint8


class AudioDiffusionPipeline:
    """Composes {unet, scheduler, mel, optional vqvae} on one device."""

    def __init__(self, unet: UNet2D, mel: Mel, scheduler: DDIMScheduler, vqvae=None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AudioDiffusionPipeline: CUDA device requested but torch.cuda is not available")
        if not isinstance(scheduler, DDIMScheduler):
            raise NotImplementedError("only DDIM is ported; DDPM waits (ROADMAP Queue 1 item 2)")
        if mel.device != self.device:
            raise ValueError(f"mel lives on {mel.device}, the pipeline on {self.device}")
        self.unet = unet.to(self.device).eval()
        self.vqvae = vqvae.to(self.device).eval() if vqvae is not None else None
        self.mel = mel
        self.scheduler = scheduler

    def get_default_steps(self) -> int:
        return self.scheduler.default_num_inference_steps()

    @property
    def sample_hw(self):
        return self.unet.config.sample_hw()

    @property
    def is_latent(self) -> bool:
        return self.vqvae is not None

    @torch.inference_mode()
    def __call__(
        self,
        batch_size: int = 1,
        steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        gl_phase: Optional[torch.Tensor] = None,
        return_arrays: bool = False,
        pcm16: bool = False,
        audio_file: Optional[str] = None,
        raw_audio=None,
        start_step: int = 0,
        mask_start_secs: float = 0,
        mask_end_secs: float = 0,
        eta: float = 0,
        encoding=None,
    ):
        """Generate mel spectrograms and audio.

        Args:
            generator: draws the noise (unless ``noise`` is given), then the
                Griffin-Lim phase (unless ``gl_phase`` is given); a fresh
                seed-0 generator on the pipeline's device when None.
            noise: (B, H, W, C) NHWC initial sample; overrides ``batch_size``.
            gl_phase: (B, x_res, n_fft // 2 + 1) initial Griffin-Lim phase in
                radians, for tests that hand both packages one phase.
            return_arrays: return ``(uint8 images, audio)`` tensors on the
                device instead of a :class:`PipelineOutput`.
            pcm16: peak-normalize and quantize the audio to int16.
        """
        if audio_file is not None or raw_audio is not None or start_step or mask_start_secs or mask_end_secs:
            raise NotImplementedError("audio-to-audio, start_step and masks wait (ROADMAP Queue 1 item 8)")
        if encoding is not None:
            raise NotImplementedError("conditional generation waits (ROADMAP Queue 1 item 9)")
        if eta:
            raise NotImplementedError("stochastic DDIM (eta > 0) in the pipeline waits (ROADMAP Queue 1 item 8)")
        steps = steps or self.get_default_steps()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        h, w = self.sample_hw
        in_ch = self.unet.config.in_channels
        if noise is None:
            noise = torch.randn((batch_size, h, w, in_ch), generator=generator, device=generator.device)
        x = torch.as_tensor(noise, dtype=torch.float32).to(self.device)

        schedule = self.scheduler.schedule(steps)
        for t in schedule.timesteps:
            t_batch = torch.full((x.shape[0],), int(t), dtype=torch.int64, device=self.device)
            x = self.scheduler.step(self.unet(x, t_batch), int(t), x, schedule)
        if self.is_latent:
            x = self.vqvae.decode(x / LATENT_SCALE)
        raw = postprocess_images(x)

        audio = self.mel.images_to_audio(raw, generator=generator, phase=gl_phase)
        if pcm16:
            audio = pcm16_quantize(audio)
        if return_arrays:
            return raw, audio
        raw_np = raw.cpu().numpy()
        return PipelineOutput([Image.fromarray(img) for img in raw_np], self.mel.get_sample_rate(),
                              list(audio.cpu().numpy()), raw_np)

    def encode(self, *args, **kwargs):
        raise NotImplementedError("DDIM inversion waits (ROADMAP Queue 1 item 8)")

    @staticmethod
    def slerp(*args, **kwargs):
        raise NotImplementedError("slerp waits (ROADMAP Queue 1 item 8)")

    def save_pretrained(self, *args, **kwargs):
        raise NotImplementedError("save_pretrained waits (ROADMAP Queue 1 item 8)")

    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        raise NotImplementedError("from_pretrained waits (ROADMAP Queue 1 item 8)")
