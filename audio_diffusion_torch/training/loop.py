"""End-to-end UNet training loop on one device (port of ``audio_diffusion_tpu/training/loop.py``).

Data, steps, logging, checkpoints and pipeline saves as the JAX loop runs
them: the epoch loop over ``epoch_batches`` with (seed, epoch) shuffles, a
restore of the latest train-state checkpoint before any expensive work (and
an early return when it already meets ``max_steps``), a mid-epoch resume
that replays the straight run's data stream, logs of {loss, lr, step,
ema_decay, grad_norm, steps_per_sec}, the pipeline saved in the diffusers
layout from the EMA parameters every ``save_model_epochs`` with a train-state
checkpoint beside it, and eval samples into tensorboard every
``save_images_epochs`` when ``tensorboardX`` imports.

What differs: one device (the JAX mesh has no counterpart, ``mesh_data`` is
not a field); ``--vae`` and ``--from_pretrained`` read the diffusers layout
through the port's loaders (a Hub id resolves from the local HF cache
only); ``push_to_hub`` raises: the port has no network path. The UNet is
built with ``fused_groupnorm=False`` as the JAX loop builds it: the
GroupNorm+SiLU kernel has no backward.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import ImageSliceDataset, epoch_batches, epoch_rng, load_encodings, prefetch
from ..mel import Mel
from ..models.unet2d import UNet2D, conditional_config, unconditional_config
from ..pipelines.pipeline import AudioDiffusionPipeline
from ..schedulers import DDIMScheduler, DDPMScheduler, SchedulerConfig
from ..utils import diffusers_io
from ..utils.hub import ensure_repo, resolve_pretrained
from .checkpoint import make_manager, restore_train_state, save_train_state
from .train_unet import TrainConfig, init_train_state, make_lr_schedule, make_train_step, precompute_latent_moments

logger = logging.getLogger("audio_diffusion_torch.training")


@dataclasses.dataclass
class RunConfig:
    dataset: str
    output_dir: str = "ddpm-model"
    num_epochs: int = 100
    train_batch_size: int = 16  # microbatch; the batch per optimizer step is this times gradient_accumulation_steps
    eval_batch_size: int = 16
    save_images_epochs: int = 10
    save_model_epochs: int = 10
    scheduler: str = "ddpm"
    num_train_steps: int = 1000
    hop_length: int = 512
    sample_rate: int = 22050
    n_fft: int = 2048
    from_pretrained: Optional[str] = None
    vae: Optional[str] = None
    encodings: Optional[str] = None
    cache_latents: bool = True  # latent training: encode the dataset once, sample posteriors per step
    mixed_precision: str = "no"  # "no" | "bf16": the UNet computes in bf16, its parameters stay f32
    seed: int = 0
    log_every: int = 10
    max_steps: Optional[int] = None  # early stop
    push_to_hub: bool = False  # raises: the port has no network path
    device: str = "cuda"
    timing: bool = False  # result["timings"]: per step the host wall and data wait, on CUDA the device times


def load_vae(path: str, device):
    """The AutoencoderKL of a diffusers-layout directory (``<path>`` or
    ``<path>/vqvae``; a Hub id resolves from the local HF cache), f32 as
    saved: encode precision is part of the data."""
    from ..models.vae import AutoencoderKL

    path = resolve_pretrained(path)
    vae_dir = path if os.path.exists(os.path.join(path, "config.json")) else os.path.join(path, "vqvae")
    vae = AutoencoderKL(diffusers_io.vae_config_from_diffusers(diffusers_io.read_json(f"{vae_dir}/config.json")))
    vae.load_state_dict(diffusers_io.load_state_dict(vae_dir), strict=True)
    return vae.to(device).eval()


def _to_device(x, device):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device)


def run_training(run: RunConfig, train: TrainConfig) -> dict:
    if run.push_to_hub:
        ensure_repo(None, run.output_dir)  # raises: the port has no network path
    device = torch.device(run.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_training: CUDA device requested but torch.cuda is not available; "
                           "pass device='cpu' to train on the CPU")

    dataset = ImageSliceDataset(run.dataset)
    resolution = dataset.resolution  # (H, W) from the data (reference: train_unet.py:70-71)
    encodings = load_encodings(run.encodings) if run.encodings else None
    conditional = encodings is not None

    vae = load_vae(run.vae, device) if run.vae is not None else None
    if vae is not None:
        sample_hw, channels = vae.config.latent_hw(*resolution), vae.config.latent_channels
    else:
        sample_hw, channels = resolution, 1

    dtype = "bfloat16" if run.mixed_precision == "bf16" else "float32"
    if run.from_pretrained is not None:
        # --mixed_precision bf16 overrides the loaded UNet's compute dtype;
        # the VAE keeps its own (loop.py:188-202)
        pipe = AudioDiffusionPipeline.from_pretrained(run.from_pretrained, device=device)
        unet = pipe.unet
        if run.mixed_precision == "bf16" and unet.config.dtype != "bfloat16":
            state_dict = unet.state_dict()
            unet = UNet2D(dataclasses.replace(unet.config, dtype="bfloat16"))
            unet.load_state_dict(state_dict, strict=True)
        if pipe.vqvae is not None:
            vae = pipe.vqvae
    else:
        if conditional:
            dim = next(iter(encodings.values())).shape[-1]
            cfg = conditional_config(sample_hw, channels, channels, cross_attention_dim=dim, dtype=dtype)
        else:
            cfg = unconditional_config(sample_hw, channels, channels, dtype=dtype)
        unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(run.seed))
    unet = unet.to(device).train()

    sched_cfg = SchedulerConfig(num_train_timesteps=run.num_train_steps)
    scheduler = DDPMScheduler(sched_cfg) if run.scheduler == "ddpm" else DDIMScheduler(sched_cfg)

    accum, micro = train.gradient_accumulation_steps, run.train_batch_size
    steps_per_epoch = len(dataset) // (micro * accum)
    train = dataclasses.replace(train, total_steps=max(steps_per_epoch * run.num_epochs, train.lr_warmup_steps + 1))
    lr_schedule = make_lr_schedule(train)

    state = init_train_state(train, unet)
    manager = make_manager(os.path.join(run.output_dir, "checkpoints"))
    if restore_train_state(manager, state) is not None:
        logger.info("resumed from step %d", state.step)
    if run.max_steps and state.step >= run.max_steps:  # nothing to train (loop.py:231-241)
        logger.info("restored step %d already >= max_steps %d; nothing to train", state.step, run.max_steps)
        return {"steps": state.step, "loss": float("nan"), "seconds": 0.0, "output_dir": run.output_dir,
                "losses": []}

    precomputed = None
    if vae is not None and run.cache_latents:
        t_enc = time.time()
        precomputed = precompute_latent_moments(vae, dataset)
        logger.info("cached latent moments for %d items in %.1f s (%s)",
                    len(precomputed[1]), time.time() - t_enc, precomputed[0].shape)

    step_fn = make_train_step(train, unet, scheduler, vae, conditional, cached_latents=precomputed is not None,
                              record_events=run.timing)

    writer = None
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(run.output_dir, "logs"))
    except ImportError:
        logger.warning("tensorboardX unavailable; metrics go to stdout only")

    mel = Mel(x_res=resolution[1], y_res=resolution[0], hop_length=run.hop_length, sample_rate=run.sample_rate,
              n_fft=run.n_fft, device=device)
    eval_rng = np.random.default_rng(run.seed + 0x5EED)  # eval encoding picks: a stream of their own
    global_step = state.step
    losses, waits, step_walls = [], [], []
    last_metrics = None
    t_start = time.time()
    t_last_log = None
    steps_last_log = global_step
    # Resume replays the straight run's data stream: each epoch's shuffle
    # derives from (seed, epoch), and a mid-epoch restore skips the groups
    # already taken in that epoch.
    start_epoch = global_step // max(steps_per_epoch, 1)
    resume_skip = global_step - start_epoch * steps_per_epoch
    done = False

    def place(batch):  # on the prefetch thread: the host-to-device copy overlaps the running step
        images, enc = batch
        return _to_device(images, device), _to_device(enc, device)

    for epoch in range(start_epoch, run.num_epochs):
        batches = prefetch(epoch_batches(dataset, micro, accum, epoch_rng(run.seed, epoch), encodings,
                                         precomputed=precomputed,
                                         start_group=resume_skip if epoch == start_epoch else 0), transform=place)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            waits.append(time.perf_counter() - t_wait)
            images, enc = batch
            state, metrics = step_fn(state, images, enc, seed=run.seed)
            step_walls.append(time.perf_counter() - t_wait)
            last_metrics = metrics
            losses.append(metrics["loss"])
            global_step += 1
            if global_step % run.log_every == 0 or global_step == 1:
                logs = {"loss": float(metrics["loss"]), "lr": lr_schedule(global_step), "step": global_step,
                        "ema_decay": metrics["ema_decay"], "grad_norm": float(metrics["grad_norm"])}
                # float() waits for the step, so the wall between log lines is
                # steady-state throughput (the first window is skipped)
                now = time.time()
                if t_last_log is not None:
                    logs["steps_per_sec"] = round((global_step - steps_last_log) / (now - t_last_log), 3)
                t_last_log, steps_last_log = now, global_step
                logger.info("epoch %d step %d: %s", epoch, global_step, logs)
                if writer:
                    for k, v in logs.items():
                        writer.add_scalar(k, v, global_step)
            if run.max_steps and global_step >= run.max_steps:
                done = True
                break
        batches.close()

        should_save = (epoch + 1) % run.save_model_epochs == 0 or epoch == run.num_epochs - 1 or done
        should_sample = (epoch + 1) % run.save_images_epochs == 0 and writer is not None
        if should_save or should_sample:
            eval_unet = UNet2D(unet.config)
            eval_unet.load_state_dict(state.ema_params if train.use_ema else state.params, strict=True)
            eval_pipe = AudioDiffusionPipeline(eval_unet, mel, scheduler, vae, device=device)
        if should_save:
            eval_pipe.save_pretrained(run.output_dir)
            save_train_state(manager, global_step, state)
        if should_sample:
            enc_eval = None
            if conditional:
                vals = list(encodings.values())
                pick = eval_rng.choice(len(vals), size=min(run.eval_batch_size, len(vals)), replace=False)
                enc_eval = np.stack([vals[i] for i in pick])[:, None, :]
            eval_bs = len(enc_eval) if enc_eval is not None else run.eval_batch_size
            out = eval_pipe(batch_size=eval_bs, generator=torch.Generator(device=device).manual_seed(42),
                            encoding=enc_eval)
            writer.add_images("test_samples", out.raw_images[:, None, :, :], epoch)
            from ..ops.audio_io import normalize

            try:
                for i, audio in enumerate(out.audios):
                    writer.add_audio(f"test_audio_{i}", normalize(audio)[None, :], epoch, sample_rate=out.sample_rate)
            except ImportError:  # tensorboardX add_audio needs soundfile
                logger.warning("soundfile unavailable; skipping tensorboard audio logging")
        if should_save or should_sample:
            del eval_pipe, eval_unet
            t_last_log = None  # the save/eval wall is not training: restart the throughput window
        if done:
            break

    if writer:
        writer.close()
    result = {"steps": global_step,
              "loss": float(last_metrics["loss"]) if last_metrics is not None else float("nan"),
              "seconds": time.time() - t_start, "output_dir": run.output_dir,
              "losses": [float(x) for x in losses]}
    if run.timing:
        result["timings"] = {"step_ms": [1e3 * w for w in step_walls], "data_wait_ms": [1e3 * w for w in waits],
                             "fwd_bwd_ms": [a.elapsed_time(b) for a, b, _ in step_fn.events],
                             "optimizer_ema_ms": [b.elapsed_time(c) for _, b, c in step_fn.events]}
    return result
