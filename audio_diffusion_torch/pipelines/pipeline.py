"""AudioDiffusionPipeline (port of ``audio_diffusion_tpu/pipelines/pipeline.py``).

The JAX package compiles generation into one program
(``_fused_generate_fn``, pipeline.py:317-401). Here the same stages run
eagerly on one device, in the same order:

    noise -> [mel forward of the input audio -> [VAE encode] -> re-noise at
    start_step] -> DDIM/DDPM loop of UNet + scheduler step [+ column-mask
    overwrite] -> [VAE decode of latents / LATENT_SCALE] -> uint8
    postprocess -> NNLS + Griffin-Lim -> [int16 PCM]

There is no CPU fallback: the pipeline runs on the device it is given, and on
a CUDA device every kernel wrapper launches its kernel or raises.

The per-step mask overwrite uses the noise level of the *current* timestep
``t`` although the sample was just stepped to ``t_prev``: the reference's
off-by-one, kept for parity (pipeline.py:23-26).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

from ..mel import Mel
from ..models.unet2d import UNet2D
from ..models.vae import AutoencoderKL
from ..schedulers import DDIMScheduler, DDPMScheduler, load_scheduler
from ..schedulers.common import step_noises
from ..utils import diffusers_io
from ..utils.hub import resolve_pretrained

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

    def __init__(self, unet: UNet2D, mel: Mel, scheduler: Union[DDIMScheduler, DDPMScheduler], vqvae=None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AudioDiffusionPipeline: CUDA device requested but torch.cuda is not available")
        if not isinstance(scheduler, (DDIMScheduler, DDPMScheduler)):
            raise TypeError(f"unsupported scheduler {type(scheduler).__name__}")
        if mel.device != self.device:
            raise ValueError(f"mel lives on {mel.device}, the pipeline on {self.device}")
        self.unet = unet.to(self.device).eval()
        self.vqvae = vqvae.to(self.device).eval() if vqvae is not None else None
        self.mel = mel
        self.scheduler = scheduler

    def get_default_steps(self) -> int:
        """50 for DDIM, num_train_timesteps for DDPM."""
        return self.scheduler.default_num_inference_steps()

    @property
    def sample_hw(self):
        return self.unet.config.sample_hw()

    @property
    def is_latent(self) -> bool:
        return self.vqvae is not None

    # ------------------------------------------------------------ audio input
    def _input_slices(self, audio_file, raw_audio, slice: int):
        """Host-side audio-to-audio slice prep: ``((B or 1, slice_size) f32, batched)``.
        A 2-D ``raw_audio`` is one slice per row at the mel rate (shorter rows
        zero-pad); otherwise one clip is loaded and its ``slice`` taken."""
        batched = raw_audio is not None and np.asarray(raw_audio).ndim == 2
        if batched:
            rows = np.asarray(raw_audio, dtype=np.float32)
            full = self.mel.x_res * self.mel.hop_length
            if rows.shape[1] < full:
                rows = np.pad(rows, ((0, 0), (0, full - rows.shape[1])))
            return rows[:, : full - 1], True  # slice_size = x_res*hop - 1
        self.mel.load_audio(audio_file, raw_audio)
        return np.asarray(self.mel.get_audio_slice(slice), dtype=np.float32)[None], False

    def _prep_inputs(self, slices: np.ndarray, noise: torch.Tensor, batched: bool, t0: Optional[int],
                     generator: torch.Generator, posterior_eps: Optional[torch.Tensor]):
        """mel forward -> [-1, 1] -> [VAE encode] -> broadcast -> [re-noise at
        t0] (pipeline.py:217-254). Returns ``(images, input_images)``.

        The uint8 -> [-1, 1] conversion is the exact-integer form
        ``(u8*2 - 255)/255``. Batched rows take the posterior mode (a row's
        result must not depend on its batch); one broadcast clip takes a
        posterior sample, ``posterior_eps`` or a draw from ``generator``."""
        inp = self.mel.spectrogram_images_from_audio(slices).to(torch.float32)
        inp = ((inp * 2.0 - 255.0) / 255.0)[..., None]  # (B or 1, H, W, 1)
        if self.is_latent:
            posterior = self.vqvae.encode(inp)
            inp = LATENT_SCALE * (posterior.mode() if batched else posterior.sample(generator, eps=posterior_eps))
        input_images = inp.expand(noise.shape)
        images = noise if t0 is None else self.scheduler.add_noise(input_images, noise, t0)
        return images, input_images

    def _validate_encoding(self, encoding, batch_rows: int) -> Optional[torch.Tensor]:
        """``encoding`` as an f32 (B, seq, dim) tensor on the device, with the
        JAX package's checks and messages (pipeline.py:264-293): a 2-D (B, dim)
        encoding becomes a length-1 sequence; the last axis must be the UNet's
        cross_attention_dim and the batch the generation batch (the noise's
        leading axis, which user-supplied noise= sets)."""
        if encoding is None:
            return None
        if not self.unet.config.is_conditional:
            raise ValueError(
                "encoding= was passed but this pipeline's UNet is unconditional "
                "(config.cross_attention_dim is None) — the conditioning would be "
                "silently ignored. Load a conditional model or drop encoding=.")
        enc = torch.as_tensor(encoding, dtype=torch.float32).to(self.device)
        if enc.dim() == 2:
            enc = enc[:, None, :]
        want = self.unet.config.cross_attention_dim
        if enc.dim() != 3 or enc.shape[-1] != want:
            raise ValueError(
                f"encoding must be (batch, seq, {want}) [or (batch, {want})], "
                f"got shape {tuple(enc.shape)} — the last axis must equal the "
                f"UNet's cross_attention_dim ({want}).")
        if enc.shape[0] != batch_rows:
            raise ValueError(
                f"encoding batch axis ({enc.shape[0]}) must equal the "
                f"generation batch ({batch_rows}).")
        return enc

    # -------------------------------------------------------------- generation
    @torch.inference_mode()
    def __call__(
        self,
        batch_size: int = 1,
        audio_file: str = None,
        raw_audio: np.ndarray = None,
        slice: int = 0,
        start_step: int = 0,
        steps: int = None,
        generator: Optional[torch.Generator] = None,
        mask_start_secs: float = 0,
        mask_end_secs: float = 0,
        step_generator: Union[torch.Generator, Sequence[torch.Generator], None] = None,
        eta: float = 0,
        noise=None,
        encoding=None,
        return_dict: bool = True,
        return_images_only: bool = False,
        return_arrays: bool = False,
        pcm16: bool = False,
        gl_phase: Optional[torch.Tensor] = None,
        posterior_eps: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ):
        """Generate mel spectrograms and audio (the JAX ``__call__``, pipeline.py:404-612).

        Randomness, in the JAX package's order (pipeline.py:369): ``generator``
        (a fresh seed-0 generator on the pipeline's device when None) draws
        the noise, then the VAE posterior sample of a single input clip, then
        the Griffin-Lim phase. The variance noise of stochastic steps (DDPM,
        DDIM ``eta > 0``) comes from ``step_generator`` when given, else from
        ``generator`` as the loop runs, between the posterior and the phase.

        Args:
            audio_file / raw_audio: audio-to-audio input. A 2-D ``raw_audio``
                is one clip per row ("batched": the posterior mode); a 1-D one
                or a file is one clip broadcast over the batch ("single": a
                posterior sample), cut at ``slice``.
            start_step: re-noise the input to ``timesteps[start_step - 1]`` and
                denoise from step ``start_step``; must be < ``steps``.
            mask_start_secs / mask_end_secs: keep that many seconds of the
                input at the start / end (outpainting / inpainting).
            step_generator: one generator (the reference's shared chain), or a
                sequence of one per row, which makes each row's stochastic
                steps independent of its co-batch (serving).
            noise: (B, H, W, C) NHWC initial sample, NCHW accepted; overrides
                ``batch_size``.
            encoding: (B, seq, cross_attention_dim) conditioning of a
                conditional UNet, or (B, cross_attention_dim), a length-1
                sequence (the AudioEncoder's pooled output); every denoise
                step's UNet call takes it.
            return_dict: False gives ``(images, (sample_rate, audios))``.
            return_images_only: return the (B, H, W) uint8 spectrograms as numpy, no audio.
            return_arrays: return ``(uint8 images, audio)`` tensors on the device.
            pcm16: peak-normalize and quantize the audio to int16.
            gl_phase: (B, x_res, n_fft // 2 + 1) initial Griffin-Lim phase in
                radians; ``posterior_eps`` the standard normal draw of the
                posterior sample; ``step_noise`` (denoise steps, B, H, W, C) the
                variance noise: test hooks that hand both packages one draw.
        """
        steps = steps or self.get_default_steps()
        if start_step >= steps:
            raise ValueError(
                f"start_step ({start_step}) must be < steps ({steps}); "
                "start_step indexes the inference schedule, so a DDPM-era "
                "value like 500 must be rescaled for a 50-step DDIM run "
                "(e.g. steps // 2 for a half-strength variation).")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        h, w = self.sample_hw
        in_ch = self.unet.config.in_channels

        if noise is None:
            noise = torch.randn((batch_size, h, w, in_ch), generator=generator, device=generator.device)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(self.device)
        if noise.shape[-1] != in_ch and noise.shape[1] == in_ch:
            noise = noise.permute(0, 2, 3, 1)  # accept NCHW
        rows = noise.shape[0]
        enc = self._validate_encoding(encoding, rows)
        if isinstance(step_generator, (list, tuple)) and len(step_generator) != rows:
            raise ValueError(f"per-row step_generator batch ({len(step_generator)}) must equal the "
                             f"generation batch ({rows}).")

        images = input_images = noise
        has_input = audio_file is not None or raw_audio is not None
        frozen = None
        schedule = self.scheduler.schedule(steps)
        if has_input:
            slices, batched = self._input_slices(audio_file, raw_audio, slice)
            if batched and slices.shape[0] != rows:
                raise ValueError(f"raw_audio batch ({slices.shape[0]}) must equal the generation batch ({rows}); "
                                 "pass matching noise= or batch_size=.")
            t0 = int(schedule.timesteps[start_step - 1]) if start_step > 0 else None
            images, input_images = self._prep_inputs(slices, noise, batched, t0, generator, posterior_eps)
            # Mask pixels in model-sample space (pipeline.py:486-489).
            pixels_per_second = w * self.mel.get_sample_rate() / self.mel.x_res / self.mel.hop_length
            mask_start = int(mask_start_secs * pixels_per_second)
            mask_end = int(mask_end_secs * pixels_per_second)
            if mask_start > 0 or mask_end > 0:  # the columns the mask freezes, NHWC
                cols = torch.arange(w, device=self.device)
                frozen = ((cols < mask_start) | (cols >= w - mask_end))[None, None, :, None]

        timesteps = schedule.timesteps[start_step:]
        is_ddim = isinstance(self.scheduler, DDIMScheduler)
        stochastic = not is_ddim or eta > 0
        noises = (step_noises(tuple(images.shape), len(timesteps), self.device,
                              step_generator if step_generator is not None else generator, step_noise)
                  if stochastic else None)
        x = images
        for t in timesteps:
            t = int(t)
            model_output = self.unet(x, torch.full((rows,), t, dtype=torch.int64, device=self.device), enc)
            noise_t = next(noises) if stochastic else None
            if is_ddim:
                x = self.scheduler.step(model_output, t, x, schedule, eta=float(eta), noise=noise_t)
            else:
                x = self.scheduler.step(model_output, t, x, schedule, noise=noise_t)
            if frozen is not None:
                x = torch.where(frozen, self.scheduler.add_noise(input_images, noise, t), x)

        if self.is_latent:
            x = self.vqvae.decode(x / LATENT_SCALE)
        raw = postprocess_images(x)
        if return_images_only:
            return raw.cpu().numpy()

        audio = self.mel.images_to_audio(raw, generator=generator, phase=gl_phase)
        if pcm16:
            audio = pcm16_quantize(audio)
        if return_arrays:
            return raw, audio
        raw_np = raw.cpu().numpy()
        pil_images = [Image.fromarray(img) for img in raw_np]
        audios = list(audio.cpu().numpy())
        if not return_dict:
            return pil_images, (self.mel.get_sample_rate(), audios)
        return PipelineOutput(pil_images, self.mel.get_sample_rate(), audios, raw_np)

    # --------------------------------------------------------------- inversion
    @torch.inference_mode()
    def encode(self, images: List[Image.Image], steps: int = 50) -> torch.Tensor:
        """Deterministic DDIM inversion: images -> noise (pipeline.py:615-652).
        Feeding the result back as ``noise=`` reproduces the images. A latent
        pipeline first takes the VAE posterior mode, so the noise has the
        UNet's latent shape. Returns (B, H, W, C) on the pipeline's device.
        Unconditional, as in the JAX package (pipeline.py:645): a conditional
        UNet raises for want of an encoding."""
        if not isinstance(self.scheduler, DDIMScheduler):
            raise ValueError("encode requires DDIM (deterministic)")
        schedule = self.scheduler.schedule(steps)
        arr = np.stack([np.frombuffer(im.tobytes(), dtype="uint8").reshape((im.height, im.width)) for im in images])
        x = (torch.as_tensor(arr, dtype=torch.float32, device=self.device) / 255.0) * 2.0 - 1.0
        x = x[..., None]  # NHWC
        if self.is_latent:
            x = LATENT_SCALE * self.vqvae.encode(x).mode()
        for t in schedule.timesteps[::-1]:
            t = int(t)
            model_output = self.unet(x, torch.full((x.shape[0],), t, dtype=torch.int64, device=self.device))
            x = self.scheduler.invert_step(model_output, t, x, schedule)
        return x

    @staticmethod
    def slerp(x0, x1, alpha: float) -> torch.Tensor:
        """Spherical linear interpolation (pipeline.py:654-662)."""
        x0, x1 = torch.as_tensor(x0, dtype=torch.float32), torch.as_tensor(x1, dtype=torch.float32)
        cos = torch.dot(x0.flatten(), x1.flatten()) / (torch.linalg.norm(x0) * torch.linalg.norm(x1))
        theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        sin_theta = torch.sin(theta)
        return torch.sin((1 - alpha) * theta) / sin_theta * x0 + torch.sin(alpha * theta) / sin_theta * x1

    # ------------------------------------------------------------- persistence
    def save_pretrained(self, directory: str) -> None:
        """Write the diffusers layout that ``torch_export.save_pipeline_torch``
        writes (torch_export.py:250-290): ``model_index.json``, then ``unet/``,
        ``scheduler/``, ``mel/`` and ``vqvae/``. The JAX package's
        ``from_pretrained`` loads it; the compute ``dtype`` and
        ``fused_groupnorm`` are not stored (see :meth:`from_pretrained`)."""
        os.makedirs(directory, exist_ok=True)
        index = {
            "_class_name": "AudioDiffusionPipeline",
            "_diffusers_version": diffusers_io.DIFFUSERS_VERSION,
            "mel": ["diffusers", "Mel"],
            "scheduler": ["diffusers", type(self.scheduler).__name__],
            "unet": ["diffusers", "UNet2DConditionModel" if self.unet.config.is_conditional else "UNet2DModel"],
        }
        if self.vqvae is not None:
            index["vqvae"] = ["diffusers", "AutoencoderKL"]
        diffusers_io.write_json(index, os.path.join(directory, "model_index.json"))

        unet_dir = os.path.join(directory, "unet")
        diffusers_io.write_json(diffusers_io.unet_config_to_diffusers(self.unet.config),
                                os.path.join(unet_dir, "config.json"))
        diffusers_io.save_state_dict(self.unet, unet_dir)

        for sub, cfg, name in (("scheduler", self.scheduler.config, type(self.scheduler).__name__),
                               ("mel", self.mel.config, "Mel")):
            d = {**cfg.config_dict(), "_class_name": name, "_diffusers_version": diffusers_io.DIFFUSERS_VERSION}
            d.pop("_version")
            diffusers_io.write_json(d, os.path.join(directory, sub, cfg.config_name))

        if self.vqvae is not None:
            vae_dir = os.path.join(directory, "vqvae")
            diffusers_io.write_json(diffusers_io.vae_config_to_diffusers(self.vqvae.config),
                                    os.path.join(vae_dir, "config.json"))
            diffusers_io.save_state_dict(self.vqvae, vae_dir)

    @classmethod
    def from_pretrained(cls, directory: str, dtype: Optional[str] = None, fused_groupnorm: Optional[bool] = None,
                        device: torch.device | str = "cuda") -> "AudioDiffusionPipeline":
        """Load a pipeline directory in the diffusers layout: what
        :meth:`save_pretrained` or the JAX package's ``save_pipeline_torch``
        writes.

        ``dtype`` ("float32" | "bfloat16") overrides the compute dtype of the
        UNet and VAE (weights stay f32), as the JAX method does. The
        diffusers config carries no ``fused_groupnorm``: without
        ``fused_groupnorm=True`` the loaded UNet takes torch's GroupNorm, not
        the kernel. ``directory`` may also be a Hub model id like
        ``teticio/audio-diffusion-256``, resolved from the local HF cache
        only (:func:`..utils.hub.resolve_pretrained`)."""
        directory = resolve_pretrained(directory)
        unet_dir = os.path.join(directory, "unet")
        unet_cfg = diffusers_io.unet_config_from_diffusers(diffusers_io.read_json(f"{unet_dir}/config.json"))
        overrides = {k: v for k, v in (("dtype", dtype), ("fused_groupnorm", fused_groupnorm)) if v is not None}
        unet = UNet2D(dataclasses.replace(unet_cfg, **overrides))
        unet.load_state_dict(diffusers_io.linear_from_conv1x1(diffusers_io.load_state_dict(unet_dir), unet),
                             strict=True)

        scheduler = load_scheduler(os.path.join(directory, "scheduler"))
        # a top-level mel_config.json is read too, as torch_import.py:531 reads it
        mel_dir = directory if os.path.exists(os.path.join(directory, "mel_config.json")) else f"{directory}/mel"
        mel = Mel.from_pretrained(mel_dir, device=device)

        vqvae = None
        vae_dir = os.path.join(directory, "vqvae")
        if os.path.isdir(vae_dir):
            vae_cfg = diffusers_io.vae_config_from_diffusers(diffusers_io.read_json(f"{vae_dir}/config.json"))
            if dtype is not None:
                vae_cfg = dataclasses.replace(vae_cfg, dtype=dtype)
            vqvae = AutoencoderKL(vae_cfg)
            vqvae.load_state_dict(diffusers_io.load_state_dict(vae_dir), strict=True)
        return cls(unet, mel, scheduler, vqvae, device=device)
