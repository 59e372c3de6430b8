"""AudioDiffusionPipeline (port of ``audio_diffusion_tpu/pipelines/pipeline.py``).

A request runs these stages, in this order:

    noise -> [mel forward of the input audio -> [VAE encode] -> re-noise at
    start_step] -> DDIM/DDPM loop of UNet + scheduler step [+ column-mask
    overwrite] -> [VAE decode of latents / LATENT_SCALE] -> uint8
    postprocess -> NNLS + Griffin-Lim -> [int16 PCM]

Every call runs as cached programs, the counterparts of the JAX package's
jitted functions, each in ``pipe._compiled`` under its key. On a CUDA device
a program's first call warms it up and captures it as CUDA graphs into the
pipeline's one graph memory pool; every later call with that key copies the
request into the program's static inputs and replays the graphs. On the CPU
the same program functions run on the static inputs without a capture. A
failed capture or replay raises; nothing falls back.

- ``pipe.fuse`` (default True, as in the JAX package) runs a request as one
  program per request signature, the counterpart of ``_fused_generate_fn``
  (pipeline.py:317-401).
- ``fuse = False`` and ``return_images_only=True`` run the staged path
  (pipeline.py:508-612): one program per stage, keyed like the JAX ones:
  ``("prep", input_mode, t0, ...)`` (``_prep_fn``), ``("denoise", steps,
  start_step, eta, mask_start, mask_end, input_mode, encoding shape, ...)``
  (``_denoise_fn``; ``input_mode`` for its ``has_input``: a single clip's
  input is one row broadcast over the batch, a static input of another
  layout), ``("vae_decode", ...)`` or ``("postprocess", ...)``
  (decode and postprocess), ``("audio", pcm16, ...)`` (NNLS + Griffin-Lim
  and ``"pcm16"``). ``return_images_only`` stops after the decode.
- :meth:`AudioDiffusionPipeline.encode` runs ``("vae_encode_mode", ...)``
  and ``("encode", steps, ...)``, as the JAX package (pipeline.py:140-150,
  615-652).

Every random draw is made outside the programs, in the eager order (noise,
the posterior eps of one broadcast clip, the step noises, the Griffin-Lim
phase), and copied into the static inputs, so every path sees the same
numbers and gives the same bits. :meth:`AudioDiffusionPipeline._uncaptured`
runs calls op by op, outside any program (the role of ``jax.disable_jit()``):
the reference the programs are tested against, and the path for profilers
and module hooks, which see a replay but not its calls.

There is no CPU fallback: the pipeline runs on the device it is given, and on
a CUDA device every kernel wrapper launches its kernel or raises.

:meth:`AudioDiffusionPipeline.shard` splits inference over a mesh's data
axis (the JAX ``shard``, pipeline.py:112-124): one replica per device, every
batch-level random draw made on the pipeline's own device in the unsharded
order, then contiguous rows per replica through the draw-injection
arguments, and the rows gathered back in order; each replica captures and
replays its own programs. The result is the unsharded call's wherever a row
does not depend on its batch (the CPU; on the card, with cuDNN off, as the
server runs batches).

The per-step mask overwrite uses the noise level of the *current* timestep
``t`` although the sample was just stepped to ``t_prev``: the reference's
off-by-one, kept for parity (pipeline.py:23-26).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

from ..mel import Mel
from ..models.unet2d import UNet2D
from ..models.vae import AutoencoderKL
from ..ops import attention, batch_invariant_conv2d, fused_groupnorm
from ..ops.stage_mark import stage_mark
from ..schedulers import DDIMScheduler, DDPMScheduler, load_scheduler, save_scheduler
from ..schedulers.common import step_noises
from ..utils import diffusers_io
from ..utils.hub import resolve_pretrained

LATENT_SCALE = 0.18215  # SD latent scaling (pipeline.py:47)
# The step noise pre-drawn for one replay is bounded: a signature whose
# stochastic steps need more (DDPM at pixel-256, batch 32, 1,000 steps: 8.4 GB)
# is captured as consecutive graphs of at most this many bytes of steps each,
# with each graph's draws made just before its replay.
STEP_NOISE_BYTES = 1 << 30
# The kernel wrappers whose launch counters a replay credits.
LAUNCH_COUNTERS = (fused_groupnorm.group_norm_silu, attention.flash_mha,
                   batch_invariant_conv2d.batch_invariant_conv2d)


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


def _canonical(t: torch.Tensor) -> torch.Tensor:
    """``t`` with the strides of a new contiguous tensor of its shape, copied
    if it has other ones: a size-1 dim's stride too, which cuDNN and oneDNN
    read when they choose a layout (see :meth:`AudioDiffusionPipeline._stage`)."""
    if t.stride() == torch.empty(t.shape, device="meta").stride():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _given(**tensors) -> dict:
    """The keyword arguments that are not None: a program's inputs."""
    return {k: v for k, v in tensors.items() if v is not None}


@dataclasses.dataclass
class PipelineOutput:
    images: List[Image.Image]
    sample_rate: int
    audios: List[np.ndarray]
    raw_images: np.ndarray  # (B, H, W) uint8


@dataclasses.dataclass(eq=False)
class Program:
    """One entry of ``pipe._compiled``, the counterpart of one jitted
    function of the JAX package: the fused request
    (:meth:`AudioDiffusionPipeline._segment`) or one stage of the staged path
    and of ``encode`` (:meth:`AudioDiffusionPipeline._stage_body`, chosen by
    ``key[0]``). It holds its static inputs, its denoise steps split into
    ``segments`` of at most :data:`STEP_NOISE_BYTES` of step noise (one
    segment unless a DDPM-scale request needs more; a stage without steps has
    one), what its function reads besides its inputs, and on a CUDA device
    one captured graph per segment.

    ``launches[j]``: what one replay of graph j launches, per counter of
    :data:`LAUNCH_COUNTERS`, recorded at capture and credited to the
    counters on every replay (a replay calls no wrapper). ``warmup_seconds``
    (the eager pass before the capture), ``capture_seconds`` and
    ``pool_bytes`` (the growth of the pipeline's graph memory pool while
    capturing) describe the capture."""

    key: tuple  # AudioDiffusionPipeline.signature for the fused request; (stage name, ...) + _fixed_key() for a stage
    inputs: dict  # name -> static input tensor
    segments: list = dataclasses.field(default_factory=lambda: [(0, 1)])  # [(i0, i1)] of timesteps, one graph each
    schedule: object = None
    timesteps: Optional[np.ndarray] = None  # the denoise steps, schedule.timesteps[start_step:]
    input_mode: str = "none"  # "none" | "batched" | "single"
    t0: Optional[int] = None  # the re-noise timestep of audio-to-audio
    eta: float = 0.0
    pcm16: bool = False
    frozen: Optional[torch.Tensor] = None  # the columns the mask freezes, NHWC
    state: dict = dataclasses.field(default_factory=dict)  # carried between segments, and the outputs
    graphs: Optional[list] = None
    launches: Optional[list] = None
    warmup_seconds: float = 0.0
    capture_seconds: float = 0.0
    pool_bytes: int = 0


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
        self.mesh = None
        self._replica_devices = None  # the mesh's data-axis devices once sharded
        self._twins = {}  # device -> the replica on it, for every device but this pipeline's
        # Run a request as one program per request signature, else as one per stage (module docstring).
        self.fuse = True
        self._eager = False  # op by op, outside any program: set by _uncaptured
        self._compiled = {}  # key -> Program
        self._lock = threading.Lock()  # one request at a time: the programs share one memory pool
        self._pool = None  # the graph memory pool every capture of this pipeline shares
        self._capture_stream = None
        self._done = None  # an event after the last request's outputs were cloned

    def shard(self, mesh) -> "AudioDiffusionPipeline":
        """Split inference over ``mesh``'s ``data`` axis (``parallel.make_mesh``):
        one replica of the UNet, VAE and Mel per device on the axis, the first
        being this pipeline's device; a device that repeats holds one replica
        (a one-card or CPU split runs its shares in turn). Every call's batch
        must then be a multiple of the data-axis size. A ``model`` axis has no
        counterpart here (the UNet is not split), so it must be 1."""
        from ..parallel.mesh import rank_device

        if dict(mesh.shape).get("model", 1) != 1:
            raise ValueError(f"mesh {dict(mesh.shape)}: the port splits inference along 'data' only; "
                             "build the mesh with num_model=1")
        devices = list(mesh.devices[:, 0])
        if devices[0] != rank_device(str(self.device)):
            raise ValueError(f"the mesh's first device {devices[0]} must be the pipeline's own ({self.device})")
        twins = {}
        for d in devices[1:]:
            if d != devices[0] and d not in twins:
                twins[d] = self._replica(d)
        # This pipeline is not in its own twins: a pipeline that held itself would live in a reference cycle,
        # and with it its graphs and graph pool, until the cycle collector ran.
        self.mesh, self._replica_devices, self._twins = mesh, devices, twins
        return self

    def _replica(self, device: torch.device) -> "AudioDiffusionPipeline":
        def copy(module):
            twin = type(module)(module.config)
            twin.load_state_dict(module.state_dict(), strict=True)
            return twin

        return AudioDiffusionPipeline(copy(self.unet), Mel.from_config(self.mel.config.config_dict(), device=device),
                                      self.scheduler, copy(self.vqvae) if self.vqvae is not None else None,
                                      device=device)

    @contextlib.contextmanager
    def _uncaptured(self):
        """Run the calls made inside op by op, outside any program, as
        ``jax.disable_jit()`` runs the JAX package's: the reference the
        programs are held against, and the path for profilers and module
        hooks, which see a graph's replay but not its calls. It covers the
        replicas of a sharded pipeline."""
        pipes = [self, *self._twins.values()]
        for p in pipes:
            p._eager = True
        try:
            yield self
        finally:
            for p in pipes:
                p._eager = False

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
        return (self._call_sharded if self.mesh is not None else self._call_one)(
            batch_size=batch_size, audio_file=audio_file, raw_audio=raw_audio, slice=slice,
            start_step=start_step, steps=steps, generator=generator, mask_start_secs=mask_start_secs,
            mask_end_secs=mask_end_secs, step_generator=step_generator, eta=eta, noise=noise, encoding=encoding,
            return_dict=return_dict, return_images_only=return_images_only, return_arrays=return_arrays,
            pcm16=pcm16, gl_phase=gl_phase, posterior_eps=posterior_eps, step_noise=step_noise)

    def _call_one(self, *, batch_size, audio_file, raw_audio, slice, start_step, steps, generator, mask_start_secs,
                  mask_end_secs, step_generator, eta, noise, encoding, return_dict, return_images_only, return_arrays,
                  pcm16, gl_phase, posterior_eps, step_noise, fuse=None):
        """``__call__`` on this pipeline's device alone; ``fuse`` None takes ``self.fuse``."""
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

        has_input = audio_file is not None or raw_audio is not None
        slices = batched = t0 = None
        mask_start = mask_end = 0
        schedule = self.scheduler.schedule(steps)
        if has_input:
            slices, batched = self._input_slices(audio_file, raw_audio, slice)
            if batched and slices.shape[0] != rows:
                raise ValueError(f"raw_audio batch ({slices.shape[0]}) must equal the generation batch ({rows}); "
                                 "pass matching noise= or batch_size=.")
            t0 = int(schedule.timesteps[start_step - 1]) if start_step > 0 else None
            # Mask pixels in model-sample space (pipeline.py:486-489).
            pixels_per_second = w * self.mel.get_sample_rate() / self.mel.x_res / self.mel.hop_length
            mask_start = int(mask_start_secs * pixels_per_second)
            mask_end = int(mask_end_secs * pixels_per_second)
        timesteps = schedule.timesteps[start_step:]
        stochastic = not isinstance(self.scheduler, DDIMScheduler) or eta > 0
        step_source = step_generator if step_generator is not None else generator

        if self._eager:  # op by op, outside any program (_uncaptured)
            images = input_images = noise
            if has_input:
                images, input_images = self._prep_inputs(slices, noise, batched, t0, generator, posterior_eps)
            noises = (step_noises(tuple(images.shape), len(timesteps), self.device, step_source, step_noise)
                      if stochastic else None)
            x = self._denoise(images, input_images, noise, enc, schedule, timesteps, eta,
                              self._frozen(mask_start, mask_end), noises)
            raw = self._decode(x)
            if return_images_only:
                return raw.cpu().numpy()
            return self._output(raw, self._audio(raw, generator, gl_phase, pcm16), return_dict, return_arrays)

        # the programs take the request's tensors in one layout, whatever the caller's
        noise, enc, posterior_eps = (None if t is None else _canonical(t) for t in (noise, enc, posterior_eps))
        input_mode = "none" if not has_input else "batched" if batched else "single"
        if input_mode == "single" and self.is_latent and posterior_eps is None:
            # the draw DiagonalGaussian.sample makes: f32, like the posterior's mean
            lh, lw = self.vqvae.config.latent_hw(self.mel.y_res, self.mel.x_res)
            posterior_eps = torch.randn((1, lh, lw, self.vqvae.config.latent_channels), generator=generator,
                                        device=generator.device)
        noises = (step_noises(tuple(noise.shape), len(timesteps), self.device, step_source, step_noise)
                  if stochastic else None)
        n = len(timesteps)  # >= 1: start_step < steps
        span = min(n, max(1, STEP_NOISE_BYTES // (noise.numel() * 4))) if stochastic else n
        denoise = dict(schedule=schedule, timesteps=timesteps, eta=float(eta),
                       frozen=self._frozen(mask_start, mask_end),
                       segments=[(i, min(i + span, n)) for i in range(0, n, span)])
        step_draws = {"step_noise": (span, *noise.shape)} if stochastic else {}
        phase = {"gl_phase": (rows, self.mel.x_res, self.mel.n_fft // 2 + 1)}
        prep = _given(slices=None if slices is None else _canonical(torch.from_numpy(slices)), noise=noise,
                      posterior_eps=posterior_eps)
        with self._lock:
            self._wait_for_clones()
            if (self.fuse if fuse is None else fuse) and not return_images_only:
                key = self.signature(steps, eta, rows, enc, pcm16, start_step, mask_start, mask_end, input_mode)
                prog = self._stage(key, {**prep, **_given(enc=enc)}, {**step_draws, **phase}, input_mode=input_mode,
                                   t0=t0, pcm16=pcm16, **denoise)
                self._execute(prog, self._segment, noises, gl_phase, generator)
                raw, audio = self._clones(prog.state["raw"], prog.state["audio"])
            else:  # the staged path: [prep,] denoise, decode [, audio], one program each
                fixed = self._fixed_key()
                x, input_images = noise, None
                if has_input:
                    stage = self._stage(("prep", input_mode, t0, rows) + fixed, prep, input_mode=input_mode, t0=t0)
                    self._execute(stage, self._stage_body)
                    x, input_images = stage.state["images"], stage.state["input_images"]
                stage = self._stage(("denoise", steps, start_step, float(eta), mask_start, mask_end, input_mode,
                                     None if enc is None else tuple(enc.shape[1:]), rows) + fixed,
                                    _given(x=x, noise=noise, input_images=input_images, enc=enc), step_draws,
                                    **denoise)
                self._execute(stage, self._stage_body, noises)
                stage = self._stage(("vae_decode" if self.is_latent else "postprocess", rows) + fixed,
                                    {"x": stage.state["x"]})
                self._execute(stage, self._stage_body)
                if return_images_only:
                    (raw,) = self._clones(stage.state["raw"])
                else:
                    stage = self._stage(("audio", pcm16, rows) + fixed, {"raw": stage.state["raw"]}, phase,
                                        pcm16=pcm16)
                    self._execute(stage, self._stage_body, None, gl_phase, generator)
                    # the spectrograms from the audio stage's static input, which no graph writes
                    raw, audio = self._clones(stage.inputs["raw"], stage.state["audio"])
        if return_images_only:
            return raw.cpu().numpy()
        return self._output(raw, audio, return_dict, return_arrays)

    # ------------------------------------------------------------------ stages
    def _frozen(self, mask_start: int, mask_end: int) -> Optional[torch.Tensor]:
        """The columns the mask freezes, NHWC, or None without a mask."""
        if mask_start <= 0 and mask_end <= 0:
            return None
        w = self.sample_hw[1]
        cols = torch.arange(w, device=self.device)
        return ((cols < mask_start) | (cols >= w - mask_end))[None, None, :, None]

    def _denoise(self, x, input_images, noise, enc, schedule, timesteps, eta, frozen, noises) -> torch.Tensor:
        """The denoise loop over ``timesteps``; ``noises`` yields each
        stochastic step's variance noise (None for deterministic DDIM)."""
        is_ddim = isinstance(self.scheduler, DDIMScheduler)
        for t in timesteps:
            t = int(t)
            model_output = self.unet(x, torch.full((), t, dtype=torch.int64, device=self.device), enc)
            noise_t = next(noises) if noises is not None else None
            if is_ddim:
                x = self.scheduler.step(model_output, t, x, schedule, eta=float(eta), noise=noise_t)
            else:
                x = self.scheduler.step(model_output, t, x, schedule, noise=noise_t)
            if frozen is not None:
                x = torch.where(frozen, self.scheduler.add_noise(input_images, noise, t), x)
        return x

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        """[VAE decode] -> (B, H, W) uint8 spectrograms."""
        if self.is_latent:
            x = self.vqvae.decode(x / LATENT_SCALE)
        return postprocess_images(x)

    def _audio(self, raw: torch.Tensor, generator, phase, pcm16: bool) -> torch.Tensor:
        """NNLS + Griffin-Lim from ``phase``, or a phase drawn from ``generator``; [int16 PCM]."""
        audio = self.mel.images_to_audio(raw, generator=generator, phase=phase)
        return pcm16_quantize(audio) if pcm16 else audio

    def _invert(self, x: torch.Tensor, schedule) -> torch.Tensor:
        """The DDIM inversion loop: ``schedule``'s timesteps in reverse, each
        a UNet call and an ``invert_step``."""
        for t in schedule.timesteps[::-1]:
            t = int(t)
            model_output = self.unet(x, torch.full((), t, dtype=torch.int64, device=self.device))
            x = self.scheduler.invert_step(model_output, t, x, schedule)
        return x

    # ---------------------------------------------------------------- programs
    def _fixed_key(self) -> tuple:
        """What a captured graph fixes besides its program's own arguments,
        the end of every key in ``self._compiled``: the scheduler (its type
        and config), the UNet's and VAE's compute dtypes, and the backend
        flags that choose kernels (cuDNN on or off, as the batcher switches
        it; cuDNN's and torch's deterministic algorithms, as a training step
        in the same process switches them; TF32), and last the UNet, VAE and
        Mel objects themselves (compared by identity): a graph reads their
        tensors where they lay at capture, so a module put in another's place
        needs a program of its own."""
        return (self.scheduler, self.unet.config.dtype, self.vqvae.config.dtype if self.vqvae is not None else None,
                torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
                (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()),
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, self.unet, self.vqvae,
                self.mel)

    def signature(self, steps, eta, rows, enc, pcm16, start_step, mask_start, mask_end, input_mode) -> tuple:
        """The key of a request's fused program in ``self._compiled``: the JAX
        package's (pipeline.py:343-345) with the encoding's (seq, dim) for its
        has-encoding flag, then :meth:`_fixed_key`. JAX's "noise generated"
        and "step key derived" flags are left out: every draw is made outside
        the program here, so they select the same program."""
        return ("fused", steps, float(eta), rows, None if enc is None else tuple(enc.shape[1:]), pcm16, start_step,
                mask_start, mask_end, input_mode) + self._fixed_key()

    def _stage(self, key: tuple, inputs: dict, draws: Optional[dict] = None, **config) -> Program:
        """The program cached under ``key`` with ``inputs`` copied into its
        static inputs; on its first call a new one, with a static input of
        each tensor of ``inputs``' shape and strides, an f32 one of each
        shape of ``draws`` (filled by :meth:`_execute` as its segments run),
        and ``config`` (Program's fields its function reads).

        The strides are the eager tensor's because a graph's kernels can
        depend on them: a (B, H, W, 1) sample whose channel stride is not 1
        (the VAE posterior's mean, a view into NCHW memory) reaches cuDNN as
        an NCHW tensor, a contiguous one as channels-last, and cuDNN rounds
        the two otherwise. A key fixes the layouts of the stage outputs that
        feed its program, and a request's own tensors arrive canonical
        (:func:`_canonical`), so a call whose input has other strides than
        its program's raises: a program never replays on a layout it was not
        captured for."""
        prog = self._compiled.get(key)
        if prog is None:
            bufs = {k: torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device=self.device)
                    for k, v in inputs.items()}
            bufs.update((k, torch.zeros(v, dtype=torch.float32, device=self.device)) for k, v in (draws or {}).items())
            prog = Program(key, bufs, **config)
        for k, v in inputs.items():
            buf = prog.inputs[k]
            if buf.shape != v.shape or buf.stride() != v.stride():
                raise RuntimeError(f"program {key[0]!r}: input {k!r} of shape {tuple(v.shape)} and strides "
                                   f"{v.stride()}, but it was made for {tuple(buf.shape)} and {buf.stride()}")
            one = tuple(0 if st == 0 else slice(None) for st in buf.stride())  # a broadcast dim holds one slice
            buf[one].copy_(v[one])
        return prog

    def _segment(self, prog: Program, j: int) -> None:
        """Segment ``j`` of the fused program, on its static inputs: [the
        input prep,] its denoise steps [, then decode, postprocess and audio].
        Stage marks (:func:`..ops.stage_mark.stage_mark`) go into the graph at
        the request's start and after the denoise, the decode and the audio."""
        inp, state = prog.inputs, prog.state
        i0, i1 = prog.segments[j]
        if j == 0:
            stage_mark(0, self.device)
            x = input_images = inp["noise"]
            if prog.input_mode != "none":
                x, input_images = self._prep_inputs(inp["slices"], inp["noise"], prog.input_mode == "batched",
                                                    prog.t0, None, inp.get("posterior_eps"))
            state["input_images"] = input_images
        else:
            x = state["x"]
        noises = iter(inp["step_noise"][: i1 - i0]) if "step_noise" in inp else None
        x = self._denoise(x, state["input_images"], inp["noise"], inp.get("enc"), prog.schedule,
                          prog.timesteps[i0:i1], prog.eta, prog.frozen, noises)
        if j < len(prog.segments) - 1:
            state["x"] = x
        else:
            stage_mark(1, self.device)
            state["raw"] = self._decode(x)
            stage_mark(2, self.device)
            state["audio"] = self._audio(state["raw"], None, inp["gl_phase"], prog.pcm16)
            stage_mark(3, self.device)

    def _stage_body(self, prog: Program, j: int) -> None:
        """Segment ``j`` of one stage's program (``prog.key[0]``), on its
        static inputs: the counterpart of one jitted stage of the JAX
        package's staged path and of its ``encode``."""
        inp, state, stage = prog.inputs, prog.state, prog.key[0]
        if stage == "prep":
            state["images"], state["input_images"] = self._prep_inputs(
                inp["slices"], inp["noise"], prog.input_mode == "batched", prog.t0, None, inp.get("posterior_eps"))
        elif stage == "denoise":
            i0, i1 = prog.segments[j]
            noises = iter(inp["step_noise"][: i1 - i0]) if "step_noise" in inp else None
            state["x"] = self._denoise(inp["x"] if j == 0 else state["x"], inp.get("input_images"), inp["noise"],
                                       inp.get("enc"), prog.schedule, prog.timesteps[i0:i1], prog.eta, prog.frozen,
                                       noises)
        elif stage in ("vae_decode", "postprocess"):
            state["raw"] = self._decode(inp["x"])
        elif stage == "audio":
            state["audio"] = self._audio(inp["raw"], None, inp["gl_phase"], prog.pcm16)
        elif stage == "vae_encode_mode":
            state["x"] = LATENT_SCALE * self.vqvae.encode(inp["x"]).mode()
        else:  # "encode"
            state["x"] = self._invert(inp["x"], prog.schedule)

    def _capture(self, prog: Program, body) -> None:
        """Warm the program up eagerly on a side stream (cuDNN and cuBLAS
        heuristics, cuFFT plans, the kernels' build, the cached device
        constants), then capture each segment (``body(prog, j)``) as a CUDA
        graph into the pipeline's one memory pool. Replays are serialised
        (``self._lock``, ``self._done``), a stage's outputs are copied into
        the next stage's static inputs before another program replays, and a
        request's outputs are cloned before the next one, so programs may
        share the pool. ``capture_error_mode="thread_local"``: the batcher's
        finisher and copy stream work on other threads while a pipeline
        captures. A capture records kernels and launches none, so the
        counters' calls made while capturing are taken back and become the
        per-replay credit."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for j in range(len(prog.segments)):
                body(prog, j)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        prog.warmup_seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graphs, launches = [], []
        try:
            for j in range(len(prog.segments)):
                graph = torch.cuda.CUDAGraph()
                before = [c.launches for c in LAUNCH_COUNTERS]
                try:
                    with torch.cuda.graph(graph, pool=self._pool, stream=stream, capture_error_mode="thread_local"):
                        body(prog, j)
                finally:
                    delta = tuple(c.launches - b for c, b in zip(LAUNCH_COUNTERS, before))
                    for c, d in zip(LAUNCH_COUNTERS, delta):
                        c.launches -= d
                graphs.append(graph)
                launches.append(delta)
        except Exception:
            prog.state.clear()
            raise
        prog.capture_seconds = time.perf_counter() - t0
        prog.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        prog.graphs, prog.launches = graphs, launches

    def _execute(self, prog: Program, body, noises=None, gl_phase=None, generator=None) -> None:
        """Run ``prog`` on its static inputs and cache it: on a CUDA device
        its first call captures it (:meth:`_capture`) and every call replays
        its graphs, crediting their launches; on the CPU ``body(prog, j)``
        runs each segment j. Just before each segment its draws are written
        into the static inputs, which keeps the eager order: its steps' noises
        from ``noises``, then before the last the Griffin-Lim phase
        (``gl_phase``, or the draw Griffin-Lim makes from ``generator``)."""
        if self.device.type == "cuda" and prog.graphs is None:
            self._capture(prog, body)
        last = len(prog.segments) - 1
        for j, (i0, i1) in enumerate(prog.segments):
            for k in range(i1 - i0 if noises is not None else 0):
                prog.inputs["step_noise"][k].copy_(next(noises))
            if j == last and "gl_phase" in prog.inputs:
                if gl_phase is None:
                    gl_phase = 2.0 * math.pi * torch.rand(prog.inputs["gl_phase"].shape, generator=generator,
                                                          device=generator.device)
                prog.inputs["gl_phase"].copy_(gl_phase)
            if prog.graphs is None:
                body(prog, j)
            else:
                prog.graphs[j].replay()
                for c, d in zip(LAUNCH_COUNTERS, prog.launches[j]):
                    c.launches += d
        self._compiled[prog.key] = prog

    def _wait_for_clones(self) -> None:
        """Before a request writes the static inputs: the last request's
        clones of its outputs are done (:meth:`_clones`)."""
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)

    def _clones(self, *outputs: torch.Tensor) -> tuple:
        """Clones of a request's outputs, out of the programs' static
        tensors; on a CUDA device an event after them, which the next
        request waits on before it writes the static inputs."""
        outputs = tuple(o.clone() for o in outputs)
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
        return outputs

    def _output(self, raw: torch.Tensor, audio: torch.Tensor, return_dict: bool, return_arrays: bool):
        if return_arrays:
            return raw, audio
        raw_np = raw.cpu().numpy()
        pil_images = [Image.fromarray(img) for img in raw_np]
        audios = list(audio.cpu().numpy())
        if not return_dict:
            return pil_images, (self.mel.get_sample_rate(), audios)
        return PipelineOutput(pil_images, self.mel.get_sample_rate(), audios, raw_np)

    def _call_sharded(self, *, batch_size, audio_file, raw_audio, slice, start_step, steps, generator,
                      step_generator, eta, noise, encoding, return_dict, return_images_only, return_arrays, pcm16,
                      gl_phase, posterior_eps, step_noise, **rest):
        """``__call__`` over the replicas of :meth:`shard`. The draws the
        unsharded call makes from ``generator`` are made here first, on this
        device and in its order (noise, the posterior eps of one broadcast
        clip, the step noises, the Griffin-Lim phase), per-row step generators
        draw their rows' chains; then each replica takes its contiguous rows
        of them and of the per-row inputs, draws nothing, and the rows come
        back in order onto this device."""
        steps = steps or self.get_default_steps()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        h, w = self.sample_hw
        in_ch = self.unet.config.in_channels
        if noise is None:
            noise = torch.randn((batch_size, h, w, in_ch), generator=generator, device=generator.device)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(self.device)
        if noise.shape[-1] != in_ch and noise.shape[1] == in_ch:
            noise = noise.permute(0, 2, 3, 1)
        replicas = [self._twins.get(d, self) for d in self._replica_devices]
        rows, n = noise.shape[0], len(replicas)
        if rows % n:
            raise ValueError(f"the batch ({rows}) must be a multiple of the mesh's data-axis size ({n}): "
                             "a sharded batch splits along 'data'")
        enc = self._validate_encoding(encoding, rows)
        if isinstance(step_generator, (list, tuple)) and len(step_generator) != rows:
            raise ValueError(f"per-row step_generator batch ({len(step_generator)}) must equal the "
                             f"generation batch ({rows}).")
        batched = raw_audio is not None and np.asarray(raw_audio).ndim == 2
        if batched and len(raw_audio) != rows:
            raise ValueError(f"raw_audio batch ({len(raw_audio)}) must equal the generation batch ({rows}); "
                             "pass matching noise= or batch_size=.")
        has_input = audio_file is not None or raw_audio is not None
        if has_input and not batched and self.is_latent and posterior_eps is None:
            lh, lw = self.vqvae.config.latent_hw(self.mel.y_res, self.mel.x_res)
            posterior_eps = torch.randn((1, lh, lw, self.vqvae.config.latent_channels), generator=generator,
                                        device=generator.device)
        n_steps = len(self.scheduler.schedule(steps).timesteps[start_step:])
        if (not isinstance(self.scheduler, DDIMScheduler) or eta > 0) and step_noise is None:
            step_noise = torch.stack(list(step_noises(tuple(noise.shape), n_steps, self.device,
                                                      step_generator if step_generator is not None else generator)))
        if not return_images_only and gl_phase is None:
            gl_phase = 2.0 * math.pi * torch.rand((rows, self.mel.x_res, self.mel.n_fft // 2 + 1),
                                                  generator=generator, device=generator.device)

        def split(x, dim=0):  # n contiguous row blocks, or n times x for what every replica shares
            return x.split(rows // n, dim) if isinstance(x, torch.Tensor) else [x] * n

        per_replica = zip(replicas, split(noise), split(enc), split(step_noise, 1), split(gl_phase),
                          np.split(np.asarray(raw_audio), n) if batched else [raw_audio] * n)
        parts = []
        for rep, x, e, sn, ph, ra in per_replica:
            with torch.cuda.device(rep.device) if rep.device.type == "cuda" else contextlib.nullcontext():
                parts.append(rep._call_one(
                    batch_size=None, generator=None, step_generator=None, noise=x, encoding=e, step_noise=sn,
                    gl_phase=ph, raw_audio=ra, audio_file=audio_file, slice=slice, start_step=start_step,
                    steps=steps, eta=eta, posterior_eps=posterior_eps, return_images_only=return_images_only,
                    return_arrays=True, return_dict=True, pcm16=pcm16, fuse=self.fuse, **rest))
        if return_images_only:
            return np.concatenate(parts)
        raw = torch.cat([p[0].to(self.device) for p in parts])
        audio = torch.cat([p[1].to(self.device) for p in parts])
        return self._output(raw, audio, return_dict, return_arrays)

    # --------------------------------------------------------------- inversion
    @torch.inference_mode()
    def encode(self, images: List[Image.Image], steps: int = 50) -> torch.Tensor:
        """Deterministic DDIM inversion: images -> noise (pipeline.py:615-652).
        Feeding the result back as ``noise=`` reproduces the images. A latent
        pipeline first takes the VAE posterior mode, so the noise has the
        UNet's latent shape. Returns (B, H, W, C) on the pipeline's device.
        Unconditional, as in the JAX package (pipeline.py:645): a conditional
        UNet raises for want of an encoding.

        Two programs, as the JAX package's: ``("vae_encode_mode", shape, ...)``
        for a latent pipeline and ``("encode", steps, shape, ...)``, the
        inversion loop (module docstring). The images' conversion to the f32
        (B, H, W, 1) sample in [-1, 1] runs before them."""
        if not isinstance(self.scheduler, DDIMScheduler):
            raise ValueError("encode requires DDIM (deterministic)")
        schedule = self.scheduler.schedule(steps)
        arr = np.stack([np.frombuffer(im.tobytes(), dtype="uint8").reshape((im.height, im.width)) for im in images])
        x = (torch.as_tensor(arr, dtype=torch.float32, device=self.device) / 255.0) * 2.0 - 1.0
        x = x[..., None]  # NHWC
        if self._eager:  # op by op, outside any program (_uncaptured)
            if self.is_latent:
                x = LATENT_SCALE * self.vqvae.encode(x).mode()
            return self._invert(x, schedule)
        fixed = self._fixed_key()
        with self._lock:
            self._wait_for_clones()
            if self.is_latent:
                stage = self._stage(("vae_encode_mode", tuple(x.shape)) + fixed, {"x": x})
                self._execute(stage, self._stage_body)
                x = stage.state["x"]
            stage = self._stage(("encode", steps, tuple(x.shape)) + fixed, {"x": x}, schedule=schedule)
            self._execute(stage, self._stage_body)
            return self._clones(stage.state["x"])[0]

    @staticmethod
    def slerp(x0, x1, alpha: float) -> torch.Tensor:
        """Spherical linear interpolation (pipeline.py:654-662)."""
        x0, x1 = torch.as_tensor(x0, dtype=torch.float32), torch.as_tensor(x1, dtype=torch.float32)
        cos = torch.dot(x0.flatten(), x1.flatten()) / (torch.linalg.norm(x0) * torch.linalg.norm(x1))
        theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        sin_theta = torch.sin(theta)
        return torch.sin((1 - alpha) * theta) / sin_theta * x0 + torch.sin(alpha * theta) / sin_theta * x1

    # ------------------------------------------------------------- persistence
    def save_pretrained(self, directory: str, layout: str = "diffusers") -> None:
        """Write the pipeline in ``layout``:

        - ``"diffusers"``: what ``torch_export.save_pipeline_torch`` writes
          (torch_export.py:250-290): ``model_index.json``, then ``unet/``,
          ``scheduler/``, ``mel/`` and ``vqvae/`` with diffusers configs and
          ``diffusion_pytorch_model.bin``. The compute ``dtype`` and
          ``fused_groupnorm`` are not stored (see :meth:`from_pretrained`);
          the UNet's ``remat`` is, when set, as a key diffusers ignores.
        - ``"native"``: what the JAX package's ``save_pretrained`` writes
          (pipeline.py:677-702): the config dataclasses' own JSON (with
          ``dtype`` and ``fused_groupnorm``) and ``params.msgpack``.

        The JAX package's ``from_pretrained`` loads either. Weights files are
        written through a temporary file, an fsync and a rename."""
        if layout not in diffusers_io.LAYOUTS:
            raise ValueError(f"layout {layout!r}: expected one of {diffusers_io.LAYOUTS}")
        os.makedirs(directory, exist_ok=True)
        scheduler_name = type(self.scheduler).__name__
        if layout == "native":
            index = {"_class_name": "AudioDiffusionPipeline", "unet": True, "scheduler": scheduler_name,
                     "mel": True, "vqvae": self.vqvae is not None}
            save_scheduler(self.scheduler, os.path.join(directory, "scheduler"))
            self.mel.save_pretrained(os.path.join(directory, "mel"))
        else:
            index = {
                "_class_name": "AudioDiffusionPipeline",
                "_diffusers_version": diffusers_io.DIFFUSERS_VERSION,
                "mel": ["diffusers", "Mel"],
                "scheduler": ["diffusers", scheduler_name],
                "unet": ["diffusers", "UNet2DConditionModel" if self.unet.config.is_conditional else "UNet2DModel"],
            }
            if self.vqvae is not None:
                index["vqvae"] = ["diffusers", "AutoencoderKL"]
            for sub, cfg, name in (("scheduler", self.scheduler.config, scheduler_name),
                                   ("mel", self.mel.config, "Mel")):
                d = {**cfg.config_dict(), "_class_name": name, "_diffusers_version": diffusers_io.DIFFUSERS_VERSION}
                d.pop("_version")
                diffusers_io.write_json(d, os.path.join(directory, sub, cfg.config_name))
        diffusers_io.write_json(index, os.path.join(directory, "model_index.json"))
        diffusers_io.write_unet(self.unet, os.path.join(directory, "unet"), layout)
        if self.vqvae is not None:
            diffusers_io.write_vae(self.vqvae, os.path.join(directory, "vqvae"), layout)

    @classmethod
    def from_pretrained(cls, directory: str, dtype: Optional[str] = None, fused_groupnorm: Optional[bool] = None,
                        device: torch.device | str = "cuda") -> "AudioDiffusionPipeline":
        """Load a pipeline directory in either layout of :meth:`save_pretrained`,
        as written by this package or the JAX package (its ``save_pretrained``
        or ``save_pipeline_torch``); each weights file is detected per model
        directory (``params.msgpack``, ``.safetensors`` or ``.bin``).

        ``dtype`` ("float32" | "bfloat16") overrides the compute dtype of the
        UNet and VAE (weights stay f32), as the JAX method does, and
        ``fused_groupnorm`` the UNet's. A native config carries both; a
        diffusers config carries neither, so without ``fused_groupnorm=True``
        a UNet loaded from it takes torch's GroupNorm, not the kernel.
        ``directory`` may also be a Hub model id like
        ``teticio/audio-diffusion-256``, resolved from the local HF cache
        only (:func:`..utils.hub.resolve_pretrained`)."""
        directory = resolve_pretrained(directory)
        unet_cfg, unet_sd = diffusers_io.read_unet(os.path.join(directory, "unet"))
        overrides = {k: v for k, v in (("dtype", dtype), ("fused_groupnorm", fused_groupnorm)) if v is not None}
        unet = UNet2D(dataclasses.replace(unet_cfg, **overrides))
        unet.load_state_dict(diffusers_io.linear_from_conv1x1(unet_sd, unet), strict=True)

        scheduler = load_scheduler(os.path.join(directory, "scheduler"))
        # a top-level mel_config.json is read too, as torch_import.py:531 reads it
        mel_dir = directory if os.path.exists(os.path.join(directory, "mel_config.json")) else f"{directory}/mel"
        mel = Mel.from_pretrained(mel_dir, device=device)

        vqvae = None
        vae_dir = os.path.join(directory, "vqvae")
        if os.path.isdir(vae_dir):
            vae_cfg, vae_sd = diffusers_io.read_vae(vae_dir)
            if dtype is not None:
                vae_cfg = dataclasses.replace(vae_cfg, dtype=dtype)
            vqvae = AutoencoderKL(vae_cfg)
            vqvae.load_state_dict(vae_sd, strict=True)
        return cls(unet, mel, scheduler, vqvae, device=device)
