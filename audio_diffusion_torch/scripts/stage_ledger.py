"""Per-stage timing ledger of one generation request (the counterpart of
``scripts/stage_ledger.py``).

    python -m audio_diffusion_torch.scripts.stage_ledger                 # latent-256, batch 16, on the card
    python -m audio_diffusion_torch.scripts.stage_ledger --batch 32
    python -m audio_diffusion_torch.scripts.stage_ledger --pixel         # the pixel-space path
    python -m audio_diffusion_torch.scripts.stage_ledger --pipeline DIR  # a saved pipeline

The ledger times what ``fuse=False`` users run: the pipeline's own stage
programs (``pipelines/pipeline.py``, ``_stage``): ``denoise``, ``vae_decode``
(decode and uint8 postprocess; ``postprocess`` alone for a pixel pipeline) and
``audio`` (NNLS + Griffin-Lim and int16 PCM). It makes them with one staged
request, checks that they chained give the fused request's spectrograms
bitwise (and its audio within 2 int16 LSB), then times each by CUDA events
around ``--reps`` replays of its captured graphs (the median is kept). Where
one program holds two of the JAX ledger's stages, the smaller stage
(``postprocess_uint8``, ``pcm16``) is timed alone by events around its eager
ops and the larger takes the rest of the program's time; ``programs_ms`` keeps
each program's own time. ``noise`` is the draw the pipeline makes outside its
programs, ``d2h_payload`` the host clock around copying the uint8 spectrograms
and the int16 PCM to the host, ``fused_e2e_ms`` the host clock around a whole
fused request (one graph replay, its output clones and the same copy).

On the card the stage sum and the fused time differ by what no replay times:
the host's launches of each replay, the copies of one stage's outputs into the
next one's inputs and the clones of the fused outputs. A replay itself has no
host gap between its kernels. On the CPU (``--device cpu``) the programs run
uncaptured and every time is the host clock's.

Prints one JSON object with ms per batch (median of ``--reps``) per stage.
"""

import argparse
import time

import torch

from ..bench import AUDIO_LSB_BOUND, build_latent_pipeline, build_pixel_pipeline
from ..models import unconditional_config
from ..pipelines import AudioDiffusionPipeline
from ..pipelines.pipeline import LATENT_SCALE, pcm16_quantize, postprocess_images
from ..utils.measure import device_block, emit, median, resolve_device, stage_ms, synchronize

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--pixel", action="store_true", help="pixel-space UNet at --resolution (no VAE stage)")
    p.add_argument("--pipeline", type=str, default=None, help="ledger a saved pipeline directory")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="random weights and the request's draws")
    return p.parse_args(argv)


@torch.inference_mode()
def _program_ms(pipe: AudioDiffusionPipeline, prog, reps: int) -> float:
    """Median ms of ``prog``: its graphs replayed on the card, its stage
    function run uncaptured on the CPU."""
    if prog.graphs is not None:
        def run():
            for g in prog.graphs:
                g.replay()
    else:
        def run():
            for j in range(len(prog.segments)):
                pipe._stage_body(prog, j)
    return median(stage_ms(run, reps, pipe.device))


def main(argv=None, pipe: AudioDiffusionPipeline = None) -> dict:
    """Build (or take ``pipe``), ledger, print and return the JSON object."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if pipe is not None:
        source = "given"
    elif args.pipeline:
        pipe = AudioDiffusionPipeline.from_pretrained(args.pipeline, dtype=args.dtype, fused_groupnorm=True,
                                                      device=device)
        source = args.pipeline
    elif args.pixel:
        cfg = unconditional_config(sample_size=(args.resolution, args.resolution), dtype=args.dtype,
                                   fused_groupnorm=True)
        pipe, source = build_pixel_pipeline(cfg, args.resolution, device, args.seed), "pixel random-init"
    else:
        pipe = build_latent_pipeline(args.resolution, args.dtype, True, device, args.seed)
        source = "latent random-init"

    B, steps, reps = args.batch, args.steps, args.reps
    h, w = pipe.sample_hw
    in_ch = pipe.unet.config.in_channels
    mel = pipe.mel
    gen = lambda i: torch.Generator(device=device).manual_seed(args.seed + i)  # noqa: E731
    ledger = {}

    # -- noise: the draw __call__ makes outside its programs
    ledger["noise"] = median(stage_ms(lambda: torch.randn((B, h, w, in_ch), generator=gen(0), device=device),
                                      reps, device))
    noise = torch.randn((B, h, w, in_ch), generator=gen(0), device=device)

    # -- one staged request makes the stage programs; the fused request with the same draws is its reference
    kw = dict(noise=noise, steps=steps, return_arrays=True, pcm16=True)
    fuse = pipe.fuse
    try:
        pipe.fuse = False
        raw_s, pcm_s = pipe(generator=gen(1), **kw)
        pipe.fuse = True
        raw_f, pcm_f = pipe(generator=gen(1), **kw)
    finally:
        pipe.fuse = fuse
    lsb = int((pcm_f.to(torch.int32) - pcm_s.to(torch.int32)).abs().max().item())
    if not torch.equal(raw_s, raw_f) or lsb > AUDIO_LSB_BOUND:
        raise RuntimeError(f"the stage programs chained diverged from the fused request: spectrograms equal "
                           f"{torch.equal(raw_s, raw_f)}, audio {lsb} int16 LSB (bound {AUDIO_LSB_BOUND})")
    fixed = pipe._fixed_key()
    denoise = pipe._compiled[("denoise", steps, 0, 0.0, 0, 0, "none", None, B) + fixed]
    decode = pipe._compiled[("vae_decode" if pipe.is_latent else "postprocess", B) + fixed]
    audio_prog = pipe._compiled[("audio", True, B) + fixed]
    programs = {"denoise": _program_ms(pipe, denoise, reps),
                "vae_decode" if pipe.is_latent else "postprocess": _program_ms(pipe, decode, reps),
                "audio": _program_ms(pipe, audio_prog, reps)}

    # -- the stages inside the programs; the smaller ones timed alone on the programs' own data
    ledger[f"denoise_scan_{steps}_steps"] = programs["denoise"]
    with torch.inference_mode():
        latents = denoise.state["x"]
        images = pipe.vqvae.decode(latents / LATENT_SCALE) if pipe.is_latent else latents
        post = median(stage_ms(lambda: postprocess_images(images), reps, device))
        if pipe.is_latent:
            ledger["vae_decode"] = programs["vae_decode"] - post
            ledger["postprocess_uint8"] = post
        else:
            ledger["postprocess_uint8"] = programs["postprocess"]
        audio = pipe._audio(raw_s, None, audio_prog.inputs["gl_phase"], pcm16=False)
        pcm = median(stage_ms(lambda: pcm16_quantize(audio), reps, device))
    ledger[f"nnls_griffin_lim_x{mel.n_iter}"] = programs["audio"] - pcm
    ledger["pcm16"] = pcm

    # -- device-to-host of the serving payload (uint8 spectrograms + int16 PCM)
    d2h = []
    for _ in range(reps):
        r2, p2 = raw_s.clone(), pcm_s.clone()
        synchronize(device)
        t0 = time.perf_counter()
        r2.cpu(), p2.cpu()
        d2h.append((time.perf_counter() - t0) * 1e3)
    ledger["d2h_payload"] = median(d2h)
    payload_mb = (raw_s.numel() * raw_s.element_size() + pcm_s.numel() * pcm_s.element_size()) / 1e6

    # -- the fused request end to end (its program was made above)
    def run_fused(i):
        r, a = pipe(batch_size=B, steps=steps, generator=gen(10 + i), return_arrays=True, pcm16=True)
        return r.cpu().numpy(), a.cpu().numpy()

    run_fused(0)
    e2e = []
    for i in range(reps):
        synchronize(device)
        t0 = time.perf_counter()
        run_fused(i + 1)
        e2e.append((time.perf_counter() - t0) * 1e3)
    fused_ms = median(e2e)

    return emit({
        "config": {"resolution": [mel.y_res, mel.x_res], "latent_hw": [h, w] if pipe.is_latent else None,
                   "batch": B, "steps": steps, "dtype": pipe.unet.config.dtype,
                   "fused_groupnorm": pipe.unet.config.fused_groupnorm, "gl_iters": mel.n_iter, "reps": reps,
                   "seed": args.seed, "cudnn": torch.backends.cudnn.enabled, "pipeline": source},
        "ms_per_batch": ledger,
        "programs_ms": programs,
        "stage_sum_ms": sum(ledger.values()),
        "fused_e2e_ms": fused_ms,
        "fused_samples_per_sec": B / fused_ms * 1e3,
        "d2h_payload_mb": payload_mb,
        "staged_matches_fused": {"spectrograms_bitwise": True, "audio_max_lsb": lsb},
        "timer": "CUDA events around graph replays" if device.type == "cuda" else "host clock, uncaptured programs",
        "note": "the stage sum and the fused time differ by the host's launch of each replay, the copies between "
                "stage programs and the fused outputs' clones; a replay has no host gap between its kernels",
        "device": device_block(device),
    })


if __name__ == "__main__":
    main()
