"""Headline benchmark of the port: end-to-end mel generation throughput and
request latency on one card (the counterpart of the root ``bench.py``).

    python -m audio_diffusion_torch.bench                  # latent-256, batch 32, 50 DDIM steps, bf16, on the card
    python -m audio_diffusion_torch.bench --latency        # one batch-1 request at a time
    python -m audio_diffusion_torch.bench --device cpu --quick --steps 2 --iters 1 --reps 1

The default configuration is the JAX bench's latent recipe: the LDM KL-VAE
(128 x [1, 2, 4, 4] channels, 1-channel 32x32 latents) and the 6-block UNet
over the latents, 50 DDIM steps, VAE decode, uint8 postprocess, NNLS +
Griffin-Lim (32 iterations), int16 PCM and the copy to the host, with seeded
random weights (``--seed``), bf16 compute and the GroupNorm+SiLU kernel on.
``--pixel`` runs the 6-block UNet directly on ``--resolution`` pixels,
``--quick`` a small pixel UNet at 64x64, ``--pipeline DIR`` a saved pipeline.
When ``models/latent-audio-diffusion-256`` exists beside the package (what
``python -m audio_diffusion_torch.scripts.rebuild_latent256`` builds), the
default run benches it too and records it under ``"trained"``.

A request runs as a user's does: with ``--fuse`` (the default) one CUDA graph
per request signature, with ``--no-fuse`` one per stage. A warm-up call with
the exact timed signature captures them; a timed window that captures a
program fails the run. Every window ends in ``torch.cuda.synchronize()`` and a
copy of the outputs to the host, timed by the host clock.

Prints one JSON line:

- ``metric``, ``value``, ``unit``: samples/sec/chip, the best of ``--reps``
  windows of ``--iters`` requests; with ``--latency`` the median seconds of
  one batch-1 request over ``--iters`` requests. ``reps``: every window's value.
- ``fidelity``: the gates' figures. Each gate raises when it misses its bound:
  fused against staged at batch 2 and 2 steps (spectrograms bitwise, audio
  within 2 int16 LSB), the Griffin-Lim round trip (:func:`gl_bound`), and for
  a latent pipeline the benched-dtype VAE against f32 (< 2.0 uint8 MAE).
- ``config``: batch, steps, resolution, dtype, fused GroupNorm, fuse, cuDNN.
- ``setup``, apart from the timed windows: the warm-up call's seconds, and of
  the programs it captured their eager warm-up and capture seconds and the
  graph-pool bytes they added (null on the CPU, which captures nothing).
- ``launches``: the launches of ``group_norm_silu`` and ``flash_mha`` over the
  timed windows (``pipeline.LAUNCH_COUNTERS``), in all and per request. On the
  card a fused-GroupNorm run with none, or a run of a UNet with self-attention
  blocks and no attention launch, fails. On the CPU the plain versions run
  and nothing is launched.
- ``device``: :func:`..utils.measure.device_block`.

Left out, because they are TPU-only: the JAX bench's backend watchdog, its
persistent compilation cache, and ``vs_baseline`` (a ratio to a TPU target).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .mel import Mel
from .models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig, unconditional_config
from .models.unet2d import SelfAttention2D
from .pipelines import AudioDiffusionPipeline
from .pipelines.pipeline import LAUNCH_COUNTERS
from .schedulers import DDIMScheduler
from .utils.measure import device_block, emit, resolve_device, synchronize

# The pinned-seed trained artifact scripts.rebuild_latent256 writes (the port of scripts/rebuild_latent256.sh); when
# present, the default headline run benches it beside the random-init one.
TRAINED_256_DIR = Path(__file__).resolve().parents[1] / "models" / "latent-audio-diffusion-256"
TRAINED_256_HW = (256, 256)  # its output's (height, width): the random-init run it sits beside gives the same
# --quick: the JAX bench's small pixel UNet at 64x64.
QUICK_UNET = dict(sample_size=(64, 64), block_out_channels=(32, 64),
                  down_block_types=("DownBlock2D", "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"),
                  layers_per_block=1, norm_num_groups=8)
FIDELITY_BATCH = FIDELITY_STEPS = 2  # the fused-vs-staged probe: every stage runs, its programs stay cheap
FIDELITY_SEED = 99
AUDIO_LSB_BOUND = 2  # fused vs staged audio, int16 LSB
VAE_MAE_BOUND = 2.0  # benched-dtype VAE vs f32, uint8 MAE
# The Griffin-Lim round trip's frozen measured MAE per (y_res, x_res, hop) + 1.1 uint8 of margin
# (tests/goldens/mel_goldens.npz); other geometries take the loose, implementation-independent 18.
GL_BOUNDS = {(256, 256, 512): 2.41 + 1.1, (64, 64, 1024): 4.99 + 1.1, (512, 512, 512): 3.21 + 1.1}
GL_LOOSE_BOUND = 18.0


class FidelityError(RuntimeError):
    """A fidelity gate missed its bound: the benched function is not the one it claims to be."""


def build_latent_pipeline(resolution: int = 256, dtype: str = "bfloat16", fused_groupnorm: bool = True,
                          device="cuda", seed: int = 0) -> AudioDiffusionPipeline:
    """The random-init reference latent recipe: the LDM KL-VAE and the 6-block
    UNet over its latent grid (32x32 for 256 input), weights drawn from ``seed``
    (the UNet) and ``seed + 1`` (the VAE) on the CPU, then moved to ``device``."""
    vae_cfg = VAEConfig(sample_size=resolution, dtype=dtype)
    vae = AutoencoderKL(vae_cfg).init_params(torch.Generator().manual_seed(seed + 1))
    cfg = unconditional_config(sample_size=vae_cfg.latent_hw(resolution, resolution), dtype=dtype,
                               fused_groupnorm=fused_groupnorm)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(seed))
    mel = Mel(x_res=resolution, y_res=resolution, hop_length=512, device=device)
    return AudioDiffusionPipeline(unet, mel, DDIMScheduler(), vae, device=device)


def build_pixel_pipeline(cfg: UNetConfig, resolution: int, device, seed: int = 0) -> AudioDiffusionPipeline:
    """A random-init pixel-space pipeline: ``cfg``'s UNet directly on mel pixels."""
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(seed))
    mel = Mel(x_res=resolution, y_res=resolution, hop_length=512, device=device)
    return AudioDiffusionPipeline(unet, mel, DDIMScheduler(), device=device)


# ------------------------------------------------------------------ gates

def check_outputs(raw: np.ndarray, audio: np.ndarray, out_hw, kind: str, trained: bool) -> None:
    """Spot checks of one request's host outputs (bench.py:123-142): uint8
    spectrograms of the Mel's shape, live int16 audio, and a contrast floor
    where one was measured (trained pipelines, random-init pixel runs at
    64x64 and 256x256); random-init latent output is legitimately near-gray."""
    if raw.dtype != np.uint8 or raw.shape[-2:] != tuple(out_hw):
        raise FidelityError(f"bad spectrogram output {raw.dtype} {raw.shape}")
    if audio.dtype != np.int16 or not np.abs(audio.astype(np.int32)).max() > 1000:
        raise FidelityError("silent or degenerate audio output")
    pixel_measured = not kind and tuple(out_hw) in ((64, 64), (256, 256))
    min_std = 5.0 if (trained or pixel_measured) else 0.0
    if not raw.std() > min_std:
        raise FidelityError(f"constant or degenerate spectrogram output (std {raw.std():.3f} <= {min_std})")


def fused_staged_gate(pipe: AudioDiffusionPipeline, encoding=None) -> int:
    """Fused against staged on ``pipe`` at batch 2 and 2 steps (bench.py:147-166):
    the spectrograms bitwise, the audio within :data:`AUDIO_LSB_BOUND`. Returns
    the audio's largest difference in int16 LSB."""
    kw = dict(batch_size=FIDELITY_BATCH, steps=FIDELITY_STEPS, encoding=encoding, return_arrays=True, pcm16=True)
    fuse = pipe.fuse
    try:
        pipe.fuse = True
        raw_f, audio_f = pipe(generator=torch.Generator(device=pipe.device).manual_seed(FIDELITY_SEED), **kw)
        pipe.fuse = False
        raw_s, audio_s = pipe(generator=torch.Generator(device=pipe.device).manual_seed(FIDELITY_SEED), **kw)
    finally:
        pipe.fuse = fuse
    if not torch.equal(raw_f, raw_s):
        raise FidelityError("the fused program diverged from the staged programs (spectrograms)")
    lsb = int((audio_f.to(torch.int32) - audio_s.to(torch.int32)).abs().max().item())
    if lsb > AUDIO_LSB_BOUND:
        raise FidelityError(f"fused audio drifted {lsb} int16 LSB from staged (bound {AUDIO_LSB_BOUND})")
    return lsb


def probe_audio(mel: Mel) -> np.ndarray:
    """The gates' synthetic clip, one slice (bench.py:170-174): three partials
    and a seeded noise floor."""
    rng = np.random.default_rng(0)
    t = np.arange(mel.slice_size) / mel.get_sample_rate()
    audio = sum(np.sin(2 * np.pi * f * t) * a for f, a in ((220.0, 0.5), (587.33, 0.3), (1760.0, 0.2)))
    return (audio + 0.1 * rng.standard_normal(mel.slice_size)).astype(np.float32)


def gl_bound(mel: Mel) -> float:
    """The round trip's bound for the Mel's (y_res, x_res, hop) geometry."""
    return GL_BOUNDS.get((mel.y_res, mel.x_res, mel.hop_length), GL_LOOSE_BOUND)


def gl_roundtrip_mae(mel: Mel, projection: str = "fft", phase=None) -> float:
    """Audio -> mel image -> NNLS + Griffin-Lim -> mel image, the uint8 MAE
    between the two images (bench.py:168-189). ``phase``: the Griffin-Lim
    initial phase, else the Mel's seed-0 draw."""
    audio = probe_audio(mel)
    img = mel.spectrogram_images_from_audio(audio[None])
    rec = mel.images_to_audio(img, phase=phase, projection=projection)[0]
    rec = torch.nn.functional.pad(rec, (0, mel.slice_size - rec.shape[0]))
    img2 = mel.spectrogram_images_from_audio(rec[None])
    return (img.float() - img2.float()).abs().mean().item()


@torch.inference_mode()
def vae_dtype_mae(vae: AutoencoderKL, mel: Mel) -> float:
    """The VAE's encode -> mode -> decode round trip of the probe's image in
    its compute dtype against the same weights in f32, as uint8 MAE
    (bench.py:191-207)."""
    img = mel.spectrogram_images_from_audio(probe_audio(mel)[None])
    x = (img.float() / 255.0 * 2 - 1)[..., None]  # (1, y_res, x_res, 1)
    vae32 = AutoencoderKL(dataclasses.replace(vae.config, dtype="float32"))
    vae32.load_state_dict(vae.state_dict(), strict=True)
    vae32 = vae32.to(x.device).eval()
    rec = vae.decode(vae.encode(x).mode()).float()
    rec32 = vae32.decode(vae32.encode(x).mode())
    return (rec - rec32).abs().mean().item() * 127.5


def fidelity_gate(pipe: AudioDiffusionPipeline, encoding=None) -> dict:
    """The three gates on the benched pipeline (bench.py:144-210); each raises
    :class:`FidelityError` when it misses its bound."""
    lsb = fused_staged_gate(pipe, encoding)
    mae, bound = gl_roundtrip_mae(pipe.mel), gl_bound(pipe.mel)
    if not mae < bound:
        raise FidelityError(f"GL round-trip MAE {mae:.4f} >= {bound}: the inverse path regressed")
    vae_mae = None
    if pipe.is_latent:
        vae_mae = vae_dtype_mae(pipe.vqvae, pipe.mel)
        if not vae_mae < VAE_MAE_BOUND:
            raise FidelityError(f"the {pipe.vqvae.config.dtype} VAE round trip drifted {vae_mae:.4f} uint8 MAE "
                                f"from f32 (bound {VAE_MAE_BOUND})")
    return {"fused_staged_audio_lsb": lsb, "gl_roundtrip_mae": mae, "gl_bound": bound, "vae_dtype_mae": vae_mae,
            "vae_bound": VAE_MAE_BOUND if pipe.is_latent else None}


# ---------------------------------------------------------------- measure

def _launches() -> dict:
    return {c.__name__: c.launches for c in LAUNCH_COUNTERS}


def _measure(pipe: AudioDiffusionPipeline, args, kind: str, trained: bool) -> dict:
    """Warm up with the exact timed signature, run the timed window(s), check
    every output and the launches, apply the fidelity gates; returns {value,
    unit, reps, fidelity, setup, launches}."""
    device = pipe.device
    out_hw = (pipe.mel.y_res, pipe.mel.x_res)
    batch = 1 if args.latency else args.batch

    def encoding(rows):
        # Conditional pipelines need an encoding per row: a fixed seeded one (its values cost nothing).
        if not pipe.unet.config.is_conditional:
            return None
        dim = pipe.unet.config.cross_attention_dim
        return torch.randn((rows, 1, dim), generator=torch.Generator().manual_seed(args.seed))

    def request(rows, i):
        gen = torch.Generator(device=device).manual_seed(args.seed + i)
        return pipe(batch_size=rows, steps=args.steps, generator=gen, encoding=encoding(rows), return_arrays=True,
                    pcm16=True)

    def to_host(outs):
        synchronize(device)
        return [(raw.cpu().numpy(), audio.cpu().numpy()) for raw, audio in outs]

    before = set(pipe._compiled)
    synchronize(device)
    t0 = time.perf_counter()
    to_host([request(batch, 0)])
    first_call = time.perf_counter() - t0
    new = [p for k, p in pipe._compiled.items() if k not in before]
    captured = device.type == "cuda"
    setup = {"first_call_s": first_call, "programs_made": len(new),
             "warmup_s": sum(p.warmup_seconds for p in new) if captured else None,
             "capture_s": sum(p.capture_seconds for p in new) if captured else None,
             "pool_bytes": sum(p.pool_bytes for p in new) if captured else None}

    programs = len(pipe._compiled)
    start = _launches()
    if args.latency:
        # Sequential requests, each copied to the host before the next: what one interactive request sees.
        reps = []
        for i in range(args.iters):
            t0 = time.perf_counter()
            (raw, audio), = to_host([request(1, i + 1)])
            reps.append(time.perf_counter() - t0)
            check_outputs(raw, audio, out_hw, kind, trained)
        requests = args.iters
    else:
        # Serving loop: enqueue every request of the window, then copy all to the host; the best window counts.
        reps = []
        for rep in range(args.reps):
            t0 = time.perf_counter()
            host = to_host([request(batch, rep * args.iters + i + 1) for i in range(args.iters)])
            dt = time.perf_counter() - t0
            for raw, audio in host:
                check_outputs(raw, audio, out_hw, kind, trained)
            reps.append(batch * args.iters / dt)
        requests = args.reps * args.iters
    if len(pipe._compiled) != programs:
        raise RuntimeError(f"a timed window captured {len(pipe._compiled) - programs} program(s): the warm-up did "
                           "not run the timed signature")
    counts = {k: v - start[k] for k, v in _launches().items()}
    if device.type == "cuda":
        if pipe.unet.config.fused_groupnorm and not counts["group_norm_silu"]:
            raise RuntimeError("a fused-GroupNorm run launched no group_norm_silu kernel in its timed windows")
        if any(isinstance(m, SelfAttention2D) for m in pipe.unet.modules()) and not counts["flash_mha"]:
            raise RuntimeError("a UNet with self-attention blocks launched no flash_mha kernel in its timed windows")
    launches = {**counts, "requests": requests, "per_request": {k: v / requests for k, v in counts.items()}}

    fidelity = fidelity_gate(pipe, encoding(FIDELITY_BATCH))
    if args.latency:
        return {"value": float(np.median(reps)), "unit": "seconds (median)", "reps": reps, "fidelity": fidelity,
                "setup": setup, "launches": launches}
    return {"value": max(reps), "unit": "samples/sec/chip", "reps": reps, "fidelity": fidelity, "setup": setup,
            "launches": launches}


def _config(pipe: AudioDiffusionPipeline, args, source: str) -> dict:
    return {"pipeline": source, "batch": 1 if args.latency else args.batch, "steps": args.steps,
            "iters": args.iters, "reps": args.iters if args.latency else args.reps,
            "resolution": [pipe.mel.y_res, pipe.mel.x_res], "sample_hw": list(pipe.sample_hw),
            "dtype": pipe.unet.config.dtype, "fused_groupnorm": pipe.unet.config.fused_groupnorm,
            "fuse": pipe.fuse, "cudnn": torch.backends.cudnn.enabled, "seed": args.seed}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=None,
                   help="requests' batch; default 32 for the latent paths, 16 for --pixel and --quick")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--iters", type=int, default=5, help="requests per timed window")
    p.add_argument("--reps", type=int, default=3, help="timed windows; the best is reported, every one recorded")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--quick", action="store_true", help="the small 64x64 pixel UNet")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="compute dtype; default bfloat16 for random-init configs, with --pipeline the saved one")
    p.add_argument("--pixel", action="store_true",
                   help="the pixel-space path: the 6-block UNet directly at --resolution")
    p.add_argument("--latency", action="store_true",
                   help="batch-1 request latency: sequential requests, each copied to the host before the next")
    p.add_argument("--pipeline", type=str, default=None, help="bench a saved pipeline directory")
    p.add_argument("--skip_trained", action="store_true",
                   help="skip the trained-weights side run when models/latent-audio-diffusion-256 exists")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="random weights, noise and Griffin-Lim phases")
    p.add_argument("--fused_groupnorm", action=argparse.BooleanOptionalAction, default=True,
                   help="UNetConfig.fused_groupnorm: the UNet's GroupNorm+SiLU through the kernel")
    p.add_argument("--fuse", action=argparse.BooleanOptionalAction, default=True,
                   help="pipe.fuse: one program per request signature, else one per stage")
    return p.parse_args(argv)


def main(argv=None, pipe: AudioDiffusionPipeline = None) -> dict:
    """Run the bench and print its JSON line, which is returned. ``pipe``: an
    in-process caller's pipeline, benched instead of building one (its own
    configuration is recorded; ``--fuse`` applies, and is restored after)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.batch is None:
        args.batch = 16 if (args.pixel or args.quick) else 32
    if not args.pipeline and args.dtype is None:
        args.dtype = "bfloat16"

    trained = False
    if pipe is not None:
        source = "given"
    elif args.pipeline:
        pipe = AudioDiffusionPipeline.from_pretrained(args.pipeline, dtype=args.dtype,
                                                      fused_groupnorm=args.fused_groupnorm, device=device)
        source, trained = args.pipeline, True
    elif args.quick:
        pipe = build_pixel_pipeline(UNetConfig(**QUICK_UNET, dtype=args.dtype, fused_groupnorm=args.fused_groupnorm),
                                    64, device, args.seed)
        source = "quick pixel random-init"
    elif args.pixel:
        cfg = unconditional_config(sample_size=(args.resolution, args.resolution), dtype=args.dtype,
                                   fused_groupnorm=args.fused_groupnorm)
        pipe = build_pixel_pipeline(cfg, args.resolution, device, args.seed)
        source = "pixel random-init"
    else:
        pipe = build_latent_pipeline(args.resolution, args.dtype, args.fused_groupnorm, device, args.seed)
        source = "latent random-init"
    kind = "latent " if pipe.is_latent else ""
    out_hw = (pipe.mel.y_res, pipe.mel.x_res)

    fuse = pipe.fuse
    try:
        pipe.fuse = args.fuse
        res = _measure(pipe, args, kind, trained)
        config = _config(pipe, args, source)
    finally:
        pipe.fuse = fuse
    what = "single-sample latency" if args.latency else "mel samples/sec/chip"
    out = {"metric": f"{out_hw[0]}x{out_hw[1]} {kind}{what}, {args.steps} DDIM steps + Griffin-Lim end-to-end",
           **res, "config": config}

    # The trained-weights side run: the same loop and gates (with the trained contrast gate) over the pinned
    # artifact in the benched dtype, recorded in the same line.
    if (source == "latent random-init" and not args.skip_trained and out_hw == TRAINED_256_HW
            and (TRAINED_256_DIR / "model_index.json").exists()):
        tpipe = AudioDiffusionPipeline.from_pretrained(str(TRAINED_256_DIR), dtype=args.dtype,
                                                       fused_groupnorm=args.fused_groupnorm, device=device)
        tpipe.fuse = args.fuse
        out["trained"] = {"pipeline": str(TRAINED_256_DIR.relative_to(TRAINED_256_DIR.parents[1])),
                          "dtype": args.dtype, **_measure(tpipe, args, "latent ", True)}
    out["device"] = device_block(device)
    return emit(out)


if __name__ == "__main__":
    main()
