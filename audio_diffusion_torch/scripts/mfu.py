"""FLOPs per stage of the generation hot path against their time on the card:
achieved TFLOP/s and ``mfu``, the share of the card's dense peak (the
counterpart of ``scripts/mfu.py``).

    python -m audio_diffusion_torch.scripts.mfu                  # latent-256, batch 32, bf16, on the card
    python -m audio_diffusion_torch.scripts.mfu --conditional    # the cross-attention UNet on the same latents
    python -m audio_diffusion_torch.scripts.mfu --precast        # the denoise loop with the UNet's weights in bf16
    python -m audio_diffusion_torch.scripts.mfu --no_time        # the FLOP counts only

FLOPs are counted by ``utils/flops.py`` (its docstring holds the definition:
matrix products and convolutions at nominal taps, from the configuration,
whatever runs the model), per stage:

- ``denoise_scan``: ``--steps`` UNet forwards of ``--batch`` rows;
- ``vae_decode``: the decode of ``--batch`` latents.

Each stage is timed by CUDA events around ``--reps`` replays of the
pipeline's own stage program (``return_images_only`` makes the ``denoise``
and ``vae_decode`` programs; the decode program holds the uint8 postprocess,
which is no work by the definition), and ``request`` by the host clock around
a whole fused request of the same batch (``pcm16``, copied to the host).
``achieved_tflops`` is FLOPs over that time, ``mfu`` that over the dense peak
of the precision the run computes in (:func:`..utils.flops.peak_precision`:
989 TFLOP/s bf16, 495 TF32, 67 f32, NVIDIA H100 SXM at 700 W), stated in the
line beside the card's power limit. The top-level ``mfu`` is the whole
request's: the UNet's and the VAE's FLOPs over the request's wall, whose
Griffin-Lim, copies and host gaps count as time without work. A ``mfu``
above 1.05 is impossible and fails the run.

``--precast`` times the denoise loop of a copy of the UNet whose convolutions
and linear layers that compute in bf16 hold their weights in bf16, so no
per-call cast runs; it records whether that loop gives the same latents.
``--no_time`` counts only, on the CPU or the card. Timing needs the card.
"""

import argparse
import copy
import time

import torch

from ..bench import build_latent_pipeline
from ..models import UNet2D, conditional_config
from ..pipelines import AudioDiffusionPipeline
from ..schedulers import DDIMScheduler
from ..utils import flops
from ..utils.measure import device_block, emit, median, resolve_device, stage_ms, synchronize

MFU_IMPOSSIBLE = 1.05


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--conditional", action="store_true",
                   help="the cross-attention UNet (the conditional-latent architecture) on the same latent grid")
    p.add_argument("--no_time", action="store_true", help="the FLOP counts only")
    p.add_argument("--precast", action="store_true",
                   help="time the denoise loop with the UNet's bf16-computing weights cast to bf16 beforehand")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (with --no_time)")
    p.add_argument("--seed", type=int, default=0, help="random weights and the request's draws")
    return p.parse_args(argv)


def precast_unet(unet: UNet2D, x: torch.Tensor, t: torch.Tensor, enc) -> UNet2D:
    """A copy of ``unet`` whose Conv2d and Linear modules that receive bf16
    inputs (found by one forward on ``x``) hold bf16 weights: their per-call
    cast to the compute dtype is then a no-op, and their values are the ones
    the cast makes."""
    seen = set()
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.add(m) if a[0].dtype == torch.bfloat16 else None)
             for m in unet.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            unet(x, t, enc)
    finally:
        for h in hooks:
            h.remove()
    twin = copy.deepcopy(unet)
    for m, orig in zip(twin.modules(), unet.modules()):
        if orig in seen:
            m.to(torch.bfloat16)
    return twin


@torch.inference_mode()
def _replay_ms(pipe: AudioDiffusionPipeline, prog, reps: int) -> float:
    def run():
        for g in prog.graphs:
            g.replay()
    return median(stage_ms(run, reps, pipe.device))


def main(argv=None, pipe: AudioDiffusionPipeline = None) -> dict:
    """Count (and time), print and return the JSON object. ``pipe``: an
    in-process caller's latent pipeline, used instead of building one."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cpu" and not args.no_time:
        raise ValueError("mfu times the card: on the CPU pass --no_time (the counts only)")
    if pipe is not None:
        source = "given"
    else:
        pipe = build_latent_pipeline(args.resolution, args.dtype, True, device, args.seed)
        source = "latent random-init"
    if not pipe.is_latent:
        raise ValueError("mfu counts a latent pipeline's denoise loop and VAE decode")
    image_hw = (pipe.mel.y_res, pipe.mel.x_res)
    dtype = pipe.unet.config.dtype
    B, steps = args.batch, args.steps
    enc = None
    if args.conditional:
        cfg = conditional_config(pipe.sample_hw, dtype=dtype, fused_groupnorm=True)
        unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(args.seed))
        pipe = AudioDiffusionPipeline(unet, pipe.mel, DDIMScheduler(), pipe.vqvae, device=device)
        enc = torch.zeros((B, 1, cfg.cross_attention_dim))
    cfg = pipe.unet.config

    counted = {"denoise_scan": steps * flops.unet_forward_flops(cfg, B),
               "vae_decode": flops.vae_decode_flops(pipe.vqvae.config, image_hw, B)}
    precision = flops.peak_precision(dtype)
    peak = flops.PEAK_TFLOPS[precision]
    out = {"config": {"resolution": list(image_hw), "latent_hw": list(pipe.sample_hw), "batch": B, "steps": steps,
                      "dtype": dtype, "conditional": args.conditional, "precast": args.precast,
                      "fused_groupnorm": cfg.fused_groupnorm, "cudnn": torch.backends.cudnn.enabled,
                      "pipeline": source, "seed": args.seed},
           "flops_definition": "utils/flops.py: matmuls and convolutions at nominal taps, 2 per multiply-add",
           "peak_precision": precision, "peak_tflops": peak,
           "peak_source": "NVIDIA H100 SXM data sheet, dense, at 700 W"}
    stages = {name: {"gflops": f / 1e9, "gflops_per_sample": f / B / 1e9} for name, f in counted.items()}
    out.update(stages)
    total = sum(counted.values())
    out["request"] = {"gflops": total / 1e9, "gflops_per_sample": total / B / 1e9}

    if not args.no_time:
        noise = torch.randn((B, *pipe.sample_hw, cfg.in_channels), generator=torch.Generator().manual_seed(args.seed))
        fixed = pipe._fixed_key()
        pipe(noise=noise, steps=steps, encoding=enc, return_images_only=True)
        enc_key = None if enc is None else tuple(enc.shape[1:])
        denoise = pipe._compiled[("denoise", steps, 0, 0.0, 0, 0, "none", enc_key, B) + fixed]
        decode = pipe._compiled[("vae_decode", B) + fixed]
        times = {"denoise_scan": _replay_ms(pipe, denoise, args.reps),
                 "vae_decode": _replay_ms(pipe, decode, args.reps)}
        if args.precast:
            with torch.inference_mode():
                t = torch.full((), 0, dtype=torch.int64, device=device)
                twin = precast_unet(pipe.unet, noise[:1].to(device), t, None if enc is None else enc[:1].to(device))
            cast = AudioDiffusionPipeline(twin, pipe.mel, pipe.scheduler, pipe.vqvae, device=device)
            cast(noise=noise, steps=steps, encoding=enc, return_images_only=True)
            cast_denoise = cast._compiled[("denoise", steps, 0, 0.0, 0, 0, "none", enc_key, B) + cast._fixed_key()]
            times["denoise_scan"] = _replay_ms(cast, cast_denoise, args.reps)
            out["precast_same_latents"] = bool(torch.equal(cast_denoise.state["x"], denoise.state["x"]))
        for name, ms in times.items():
            tflops = counted[name] / (ms / 1e3) / 1e12
            stages[name].update(ms=ms, achieved_tflops=tflops, mfu=tflops / peak)

        def request(i):
            gen = torch.Generator(device=device).manual_seed(args.seed + i)
            raw, audio = pipe(batch_size=B, steps=steps, generator=gen, encoding=enc, return_arrays=True, pcm16=True)
            return raw.cpu(), audio.cpu()

        request(0)
        walls = []
        for i in range(args.reps):
            synchronize(device)
            t0 = time.perf_counter()
            request(i + 1)
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = median(walls)
        tflops = total / (ms / 1e3) / 1e12
        out["request"].update(ms=ms, achieved_tflops=tflops, mfu=tflops / peak)
        out["mfu"] = tflops / peak
        shares = {name: rec["mfu"] for name, rec in (*stages.items(), ("request", out["request"]))}
        if not all(0 < v <= MFU_IMPOSSIBLE for v in shares.values()):
            raise RuntimeError(f"mfu out of (0, {MFU_IMPOSSIBLE}]: {shares} — a timer or a count is wrong")
    out["device"] = device_block(device)
    return emit(out)


if __name__ == "__main__":
    main()
