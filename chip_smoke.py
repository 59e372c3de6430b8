#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (plus detail lines):
  1. build   the CUDA kernels from ``audio_diffusion_torch/csrc`` with nvcc
  2. gn      the GroupNorm+SiLU kernel vs its plain PyTorch version on every
             route: each (C, H, W) the latent-256 UNet gives it (batch 1 and
             32) and the conditional-latent-512 UNet (batch 1 and 16), the
             pixel-256 UNet's largest slabs and a pixel-512 slab;
             f32 and bf16, eps 1e-5 and 1e-6, batch rows bitwise independent.
             Then the 64 calls of one UNet forward timed three ways: CUDA
             events around eager calls, replayed from a CUDA graph, and
             torch's F.group_norm + F.silu; the bound share of the graph time
  3. attn    the attention kernel vs its plain version on every route of
             its launch plan (small, mma, simt): h=64, d=8, N in
             {1,4,16,17,64,255,256,1000,1024} at batch 1 and 32 and N=2100
             (above the mma route's shared-memory capacity) at batch 1, plus
             d=32 and d=128; f32 and bf16; inputs are the strided views the
             UNet hands over, bitwise equal to contiguous inputs; batch row 0
             bitwise the same alone and in the batch; N=1 gives o == v. Then
             per N the kernel timed by events and graph-replayed beside plain,
             F.scaled_dot_product_attention and its bound, the largest of the
             byte, tensor and exponential floors (attn_bound)
  4. main    the full-width latent-256 pipeline (bf16, fused GroupNorm,
             seeded random weights) answers batch-1, -8 and -32 requests of
             50 DDIM steps through ``AudioDiffusionPipeline.__call__`` on its
             default fused path (each request signature one CUDA graph,
             captured by the first call and replayed after); the kernels'
             launch counters (credited per replay) must show the path went
             through them. [layers] and [profile] read the eager path (op
             by op, outside any program: ``pipe._uncaptured()``). [fused]:
             batches 1, 8 and 32 eager and from the graph: spectrograms
             bitwise, audio bitwise (or within 1 int16 LSB, the reason
             printed), 64 and 6 launches per denoise step on both paths,
             walls, peak memory, each program's capture time and graph-pool
             bytes, the credited launches of one replay against the kernels
             torch.profiler counts in it, and the device idle share of a
             graph request beside the eager one. [staged]: the staged path
             (``fuse = False``: one captured program per stage) at batches
             1, 8 and 32 beside the fused replay and the eager run (bitwise
             on the three, walls, each stage's warm-up and capture, the
             pool's growth, credited launches against the profiler's),
             ``return_images_only`` at batch 8, and ``encode`` (the DDIM
             inversion's two programs) at 1, 8 and 32, replayed and eager
             (bitwise, walls, launches per call, the round trip's uint8
             MAE)
  5. fidelity  Griffin-Lim round trip and bf16-vs-f32 VAE round trip gates
  6. serve   the same pipeline saved with ``save_pretrained`` (diffusers
             layout), loaded through ``serving.make_server`` (bf16, fused
             GroupNorm, tiers up to 8) and asked over HTTP by concurrent
             clients: 16 generations, 4 audio-to-audio at start_step 25 and 4
             at eta 0.5, all at 50 steps; every response a 200 with a full
             wav; 64 GroupNorm+SiLU and 6 attention launches per denoise step
             of every served batch; wav and json PCM identical; a seed bitwise
             the same with other companions in its tier and, at eta 0, at
             tier 1 and tier 8 (the batcher runs batches in its window:
             cuDNN off); /healthz figures; warmup captures every program the
             traffic replays (no capture after it). Then the same pipeline
             reloaded through ``make_server(dtype="float32")``: seed 1000 at
             tiers 16 and 1 bitwise one spectrogram. [tier] (the UNet
             and VAE called op by op, in bf16 and in f32): every torch
             call of a batch-8 and a batch-32 UNet forward and VAE decode
             re-run on row 0 alone (the attention blocks in one call, as
             before the f32 repair), and every module as the port runs it,
             with cuDNN's defaults, with cudnn.deterministic and inside the
             batcher's window: the calls whose row depends on the batch, the
             drift they cause (none in the window, or the run fails), the
             forward's time with and without the f32 row blocks, and the
             window's UNet forward and VAE decode with the convolution
             kernel, with cuDNN on and with the old cuDNN-off path. [conv]
             (before [tier]): every bf16 convolution of a UNet forward and a
             VAE decode at batches 8 and 32 through the batch-invariant
             convolution kernel, checked against an f32 conv and row 0
             alone, timed beside its bound, the old path and cuDNN; the f32
             convolutions left on the per-row path timed.
             [bench] (after [serve] f32): the port's measurement programs
             through their main(argv) at full width: ``bench`` (batch 32, 50
             steps, 5 requests x 3 windows) and ``bench --latency`` on this
             pipeline, ``scripts.stage_ledger --batch 32`` and ``scripts.mfu
             --batch 32`` on it, ``scripts.bench_serving`` (16 clients, tiers
             up to 8, 5 s) on the directory [serve] saved; each prints one
             JSON line, checked: on the card, no field missing or 0, the gates
             within bounds, 3,200 GroupNorm and 300 attention launches per
             bench request, mfu in (0, 1.05], nothing served failed
             [memory]: what a group left reserved before and after the cycle
             collector (after the main, cond, train and dp groups); more than
             0.25 GiB freed by the collector alone fails
  7. apps    the convenience layer at full width: the [main] pipeline saved in
             the diffusers layout and loaded through ``AudioDiffusion(dir,
             dtype="bfloat16", fused_groupnorm=True)``, 50 DDIM steps: a
             generation, an audio-to-audio generation with a 1 s mask,
             ``loop_it`` on a 120 bpm click track and on the generated clip,
             ``outpaint`` of 2 windows from a 6 s clip at a 2 s overlap, serial
             ``remix`` of 3 windows at start_step 25 (every window from the
             pinned generator state; the first window bitwise a direct call)
             and parallel ``remix`` (one call of 3 rows), the app callback
             through ``apps.get_model`` and ``wav_bytes``; output lengths by
             the stitch arithmetic, 64 GroupNorm+SiLU and 6 attention launches
             per denoise step of every call, each call's wall time.
             [prepare]: four synthetic WAVs (22.05 kHz mono, 44.1 kHz stereo,
             one with a silent slice, one shorter than a slice) through
             ``find_audio_files`` -> ``file_to_examples`` on the card and on the
             CPU (the same slices kept, images within 1 uint8, mean < 0.02, PNGs
             that decode to the images) and ``AudioEncoder.encode`` of the files
             on the card against its CPU forward; the decoder and the time per
             file. [golden]: the Mel on the card at 256 (hop 512) and 64 (hop
             1024) against tests/goldens/mel_goldens.npz: the forward image and
             the round-trip MAE at tests/test_mel.py's limits
  8. cond    the conditional tier at the flagship's full width: the
             cross-attention UNet (conditional_config, 64x64 latents, bf16,
             fused GroupNorm), the 512 VAE and Mel, DDIM at 50 steps, seeded
             random weights. The AudioEncoder (f32) encodes 4 synthetic clips
             on the card, held against its CPU forward; batch-1 and -16
             requests with those encodings through ``__call__`` (44 GroupNorm+
             SiLU and no attention-kernel launches per UNet forward), the
             conditioning shown live, an f32 forward against the CPU, the UNet
             forward at batch 16 split into GroupNorm, SDPA and the rest, the
             512 fidelity gates, and 4 encoded HTTP requests through
             ``make_server`` in one batch, a seed bitwise the same with other
             companions
  9. attn-grad  FlashMHA (the kernel forward, autograd through the
             reference_attention-order recomputation backward) on every route:
             forward bitwise flash_mha's, gradients bitwise autograd's of the
             reference and against the f32 math; the backward timed beside
             SDPA's forward+backward and its bound
 10. train   the training slice at full width through ``run_training``: a
             synthetic 64-slice PNG dataset, a seeded 256 VAE in the diffusers
             layout, the latent-256 UNet in bf16 with cached latents, micro 16
             x accum 2, 12 steps, then the same run resumed to 16; losses fall,
             6 x accum forward launches and backwards per step, no GroupNorm
             kernel; the saved pipeline answers a request; step breakdown,
             each step's peak allocated memory and a profile of 2 steps
 11. remat   UNetConfig.remat beside the same runs without it: (a) [train]'s
             pipeline with "remat": true in its unet/config.json through
             ``run_training(from_pretrained=...)``, micro 16 x accum 2, bf16,
             cached latents, 4 steps: step 1's loss bitwise, its grad_norm
             within 1e-3, 2 x 6 x accum flash_mha launches per step (the
             forward and the recompute) against 6 x accum, 6 x accum
             backwards, no GroupNorm kernel, each step's peak; the saved
             pipeline keeps the flag and answers a batch-8 request bitwise as
             a remat=False copy, with the same launches and graph pool; one
             microbatch under deterministic algorithms: its largest gradient
             difference and the memory its forward and backward add, lower
             with remat.
             (b) the conditional-latent-512 UNet (no GroupNorm kernel) at the
             reference's flat batch 16, 3 steps each through make_train_step:
             peaks, ms per step, losses (step 1 bitwise, the remat peak lower)
 12. train-pixel  the pixel-256 UNet (bf16, batch 4) takes 3 steps through
             ``make_train_step``: the mma route under autograd
 13. train-vae  the 256 LDM VAE with its PatchGAN, generator and
             discriminator steps alternating, the adversarial terms on from step 2
 14. dp      the [train] setup data parallel, one process per rank through
             ``run_training`` (this script re-run with --dp-rank): with 2 or more
             cards NCCL over min(count, 4) ranks, DDP and then FSDP; on one card
             DDP over 2 ranks on cuda:0 with gloo, beside DDP and then FSDP at
             world 1 over NCCL. Both groups run side by side with each
             other and with [shard], [encoder-train], [cond-train] and
             [rebuild]'s processes. 6 steps, then resumed to 8: every rank's losses bitwise
             the same, rank 0 alone saves, step 1 within 1e-3 of a one-process
             run, 6 x accum flash_mha launches and FlashMHA backwards per step
             on every rank; steps/s, the all-reduce of the gradient's bytes,
             each rank's peak allocated memory in a step and its device idle share
 15. shard   the [main] pipeline sharded over the cards (over [cuda:0, cuda:0]
             on one card): batch 8 at 50 steps bitwise the unsharded call with
             cuDNN off, the difference with it on; make_server over the mesh
             answers 8 concurrent requests with tiers multiples of the data size
 16. encoder-train  the full-width AudioEncoder at batch 16 with train=True,
             forward and backward: the running statistics move, encode is
             untouched by .train()
 17. native  (group interop; run after [golden]) the [main] pipeline saved in the diffusers layout,
             the JAX package's native layout (params.msgpack) and the
             diffusers layout with .safetensors weights; each reloaded
             (bf16, fused GroupNorm) answers a batch-8 request at 50 steps
             bitwise the original's, 64 GroupNorm+SiLU and 6 attention
             launches per denoise step; bytes and walls of each save and load
 18. cond-train  (group interop) the conditional recipe (scripts.cond_selectivity_evidence)
             at full width with 24 VAE and 40 UNet steps: the loss falls,
             steps/s, peak memory, the selectivity, 44 GroupNorm+SiLU
             launches per UNet forward of its evaluation and no attention
 19. rebuild  (group interop) both pinned-seed rebuild recipes
             (scripts.rebuild_latent256 and rebuild_latent512) at full width,
             their corpus and steps cut (REBUILD_CUTS): every stage on the
             card, the bf16 bench line's gates with the trained contrast
             floor, each sample's nearest-neighbour MAE under
             REBUILD_NN_BOUND (random images: ~72), each stage's launches (training: 6 flash_mha and 6 backwards per
             latent-256 step; sampling 64 / 44 GroupNorm+SiLU and 6 / 0
             attention launches per forward), a batch-2 trained request of
             each against the plain versions (uint8 within 1), and bench's
             trained-weights side run over the cut latent-256 artifact. After
             each recipe's run its VAE and UNet stages train a second time
             over the same corpus, dataset and encodings into a second
             output: every saved tensor bitwise the first's and the same
             fidelity record, or the run fails. Each recipe runs in a process
             of its own (this script re-run with --side NAME), side by side
             with the other, [dp]'s ranks, [shard], [encoder-train] and
             [cond-train]
Then one JSON line with each kernel's launches (``launches``: the [main]
requests; ``staged_launches``: the [staged] requests' staged replays;
``encode_launches``: [staged]'s replayed ``encode`` calls;
``serve_launches``: the [serve] traffic; ``apps_launches``: the
[apps] calls; ``cond_launches``: the
[cond] requests; ``train_launches``: the [train] run's forwards and
backwards; ``remat_launches``: the [remat] runs with remat (latent-256 and
conditional-latent-512); ``dp_launches``: each [dp] rank's forwards and backwards;
``shard_launches``: the [shard] calls and requests; ``bench_launches``: the
[bench] phase's programs; ``interop_launches``:
each [native] layout's request and the [cond-train] run; ``rebuild_launches``:
[rebuild]'s by recipe and stage, its plain checks and bench's side run), error and times, the card's
name and power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
STEPS = 50
REQUESTS = ((1, 101), (8, 102), (32, 103))  # (batch, generator seed)
FUSED_PROFILES = 3  # [fused], [staged]: profiled replays allowed to see the credited launches (profiled_launches)
STAGED_REPS = 1  # [staged]: calls per path, batch and kind; the median wall is printed
STAGED_IMAGES_BATCH = ROUND_TRIP_BATCH = 8  # [staged]: return_images_only, and encode's round trip
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): the bounds' denominators.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
F32_FLOPS = 67e12  # outside the tensor cores
# The special-function unit: 16 ex2 per clock per SM at compute capability 9.0
# (NVIDIA's arithmetic-instruction throughput table for CUDA). The H100 SXM's
# 132 SMs at its 1.98 GHz maximum clock give the default; the [attn] phase
# uses the card's own SM count and maximum clock.
EXP_PER_CLOCK_PER_SM = 16
H100_EXP_PER_S = EXP_PER_CLOCK_PER_SM * 132 * 1.98e9
ATTN_CHECK_N = (1, 4, 16, 17, 64, 255, 256, 1000, 1024)
ATTN_STREAM_N = 2100  # above attention.MMA_RESIDENT_KEYS: K and V stream through two buffers
ATTN_TIME_N = (1, 4, 16, 256, 1024)
SERVE_TIER = 8  # the server's largest batch tier
SERVE_ETA = 0.5
SERVE_START_STEP = 25
SERVE_REQUESTS = {"generate": 16, "audio_to_audio": 4, "eta": 4}
# The conditional tier (BASELINE.json config 5): 512x512 audio through the VAE to 64x64 latents.
COND_REQUESTS = ((1, 201), (16, 202))  # (batch, generator seed)
COND_NORMS = 44  # GroupNorm+SiLU calls per UNet forward: 22 ResnetBlock2D x 2
COND_SDPA = 32  # SDPA calls per UNet forward: 16 Transformer2D x (attn1, attn2)
COND_TIMED_BATCH = 16
COND_SERVE_TIER = 4
ENCODER_CLIPS = 4  # synthetic 10 s clips at 22,050 Hz, one encoder slice each
# The training slice: FlashMHA's gradients on every route ((B, h, N, d), dtype).
ATTN_GRAD_CASES = (((32, 64, 4, 8), "float32"), ((32, 64, 4, 8), "bfloat16"), ((32, 64, 1, 8), "float32"),
                   ((32, 64, 1, 8), "bfloat16"), ((8, 64, 256, 8), "bfloat16"), ((2, 64, 1024, 8), "bfloat16"),
                   ((2, 8, 64, 64), "float32"))
# bf16 gradients against the f32 math on the same (upcast) inputs: the reference's
# order rounds P, dP = dO V^T and the result to bf16 (2^-9 relative each) and the
# softmax backward subtracts each row's P-weighted mean of dP, which can cancel;
# the bound is taken against the largest gradient of the tensor.
ATTN_GRAD_BF16_BOUND = 2.0 ** -4
TRAIN_SLICES = 64  # synthetic 256x256 spectrogram slices
TRAIN_MICRO, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_RESUME_TO = 16, 2, 12, 16
TRAIN_LR = 3e-4
TRAIN_ATTN = 6  # SelfAttention2D calls per latent-256 UNet forward: 5 at N=4, 1 at N=1
# [remat]: UNetConfig.remat against the same run without it, latent-256 through run_training and
# conditional-latent-512 through make_train_step at the reference's flat batch 16
REMAT_STEPS, REMAT_REQUEST = 4, (8, 401)  # steps per run; the saved pipeline's (batch, generator seed)
REMAT_COND_BATCH, REMAT_COND_STEPS = 16, 3
REMAT_GRAD_NORM_RTOL = 1e-3
PIXEL_BATCH, PIXEL_STEPS = 4, 3
VAE_TRAIN_BATCH, VAE_TRAIN_STEPS, VAE_DISC_START = 4, 4, 2
# The convenience layer on the latent-256 pipeline: 2 s overlaps (the stitch functions' default)
APPS_OVERLAP_SECS, APPS_OUTPAINT_WINDOWS, APPS_REMIX_WINDOWS, APPS_REMIX_START = 2.0, 2, 3, 25
# The dp group: the [train] setup data parallel, one process per rank
DP_STEPS, DP_RESUME_TO = 6, 8
DP_MAX_RANKS = 4
DP_RANK_TIMEOUT_S = 600
SHARD_BATCH = 8
# Griffin-Lim from bitwise-equal spectrograms and phases, run at another batch
# size: its batched matmuls and FFTs round differently, so the audio agrees to
# this share of its peak, not bitwise (the serving contract is on spectrograms)
SHARD_AUDIO_BOUND = 1e-2
ENCODER_TRAIN_BATCH = 16
# The interop group: [native] reloads the [main] pipeline from each layout and answers this request
NATIVE_BATCH, NATIVE_SEED = 8, 301
NATIVE_LAYOUTS = ("diffusers", "native", "safetensors")
# [cond-train]: the recipe at full width with its 1,200 VAE and 6,000 UNet steps cut to fit the run's time
COND_TRAIN_VAE_STEPS, COND_TRAIN_UNET_STEPS = 24, 40
COND_TRAIN_CLASSES, COND_TRAIN_EVAL_BATCH = 4, 8
# [rebuild]: both rebuild recipes at full width, cut to fit the run's time: 8 files of 3 slices (the recipes: 24 of
# 2), their VAE steps (1,400, the discriminator from 600) and UNet steps (1,000, 100 warm-up) cut, the bf16 bench
# line alone (and f32) at 1 request x 1 window (5 x 3) of batch 2 (32), the conditional record at 2 samples (8);
# bench's side run at batch 2 (32); every request there, and the trained requests against the plain versions, at
# REBUILD_STEPS sampling steps (50)
REBUILD_CORPUS = ["--files", "8", "--slices", "3"]
REBUILD_CUTS = {
    "latent256": ["--vae_steps", "30", "--disc_start", "24", "--unet_steps", "30", "--unet_warmup", "10",
                  "--bench_batch", "2", "--bench_bf16_only"],
    "conditional_latent512": ["--vae_steps", "16", "--disc_start", "12", "--unet_steps", "20", "--unet_warmup", "5",
                              "--eval_batch", "2", "--bench_batch", "2", "--bench_bf16_only"],
}
# Each trained sample's nearest-neighbour MAE over the corpus (uint8) must stay under this; random images sit near 72
REBUILD_NN_BOUND = 65
REBUILD_STEPS = 5
REBUILD_BENCH = ["--bench_iters", "1", "--bench_reps", "1", "--bench_steps", str(REBUILD_STEPS), "--eval_steps",
                 str(REBUILD_STEPS)]
REBUILD_NORMS = {"latent256": 64, "conditional_latent512": COND_NORMS}  # GroupNorm+SiLU calls per UNet forward
REBUILD_ATTN = {"latent256": TRAIN_ATTN, "conditional_latent512": 0}  # SelfAttention2D calls per UNet forward
REBUILD_PLAIN = (2, 501)  # the trained request held against the plain versions: (batch, generator seed)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi prints them."""
    import torch

    from audio_diffusion_torch.utils.measure import device_block

    return device_block(torch.device("cuda", 0))["nvidia_smi"]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int, side_warmup: bool = False) -> float:
    """Mean device time of ``fn()`` captured once in a CUDA graph and replayed
    ``reps`` times: the kernels' time without the host's gaps between launches.
    ``side_warmup``: warm up on a side stream first, as torch's notes on
    capturing autograd ask."""
    import torch

    if side_warmup:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, reps)
    del graph
    return ms


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bf16_ulp(y):
    import torch

    _, e = torch.frexp(y.abs().clamp(min=torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(y), e - 8)  # bf16 keeps 8 significant bits


# ---------------------------------------------------------------------- phases

def phase_build():
    import torch

    from audio_diffusion_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load().on(torch.cuda.current_device())
    wall = time.perf_counter() - t0
    print(f"[build] ok: nvcc {lib.build_seconds:.2f} s (load {wall:.2f} s) -> {lib.path.relative_to(REPO)}")
    entry = None
    for line in lib.build_log.splitlines():  # -Xptxas -v: one "Used N registers" line per kernel
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "Used" in line and entry:
            print(f"  ptxas {entry[:60]}: {line.split(':', 1)[-1].strip()}")
    return lib


@functools.lru_cache(maxsize=None)
def slice_shapes(cfg):
    """(C, H, W) of the fused GroupNorm calls and of the Transformer2D inputs
    of one UNet forward, in order, recorded by hooks on a batch-1 forward on
    the CPU (plain path)."""
    import torch

    from audio_diffusion_torch.models.unet2d import ResnetBlock2D, Transformer2D, UNet2D

    unet = UNet2D(cfg)
    norms, transformers = [], []

    def norm_hook(mod, args):
        _, c, h, w = args[0].shape
        norms.append((c, h, w))
        norms.append((mod.norm2.num_channels, h, w))

    for m in unet.modules():
        if isinstance(m, ResnetBlock2D):
            m.register_forward_pre_hook(norm_hook)
        elif isinstance(m, Transformer2D):
            m.register_forward_pre_hook(lambda mod, args: transformers.append(tuple(args[0].shape[1:])))
    h, w = cfg.sample_hw()
    context = torch.zeros(1, 1, cfg.cross_attention_dim) if cfg.is_conditional else None
    with torch.inference_mode():
        unet(torch.zeros(1, h, w, cfg.in_channels), torch.zeros(1, dtype=torch.long), context)
    return tuple(norms), tuple(transformers)


def slice_norm_shapes(cfg):
    """(C, H, W) of the fused GroupNorm calls of one UNet forward, in order."""
    return list(slice_shapes(cfg)[0])


def gn_bytes(x) -> int:
    """Bytes one GroupNorm+SiLU call must move: x read, y written, scale and bias read."""
    return 2 * x.numel() * x.element_size() + 2 * x.shape[1] * 4


def attn_bound(shape, itemsize: int, exp_per_s: float = H100_EXP_PER_S):
    """(bound ms, bound_by) of one attention call on q of ``shape`` (B, h, N, d):
    the largest of three floors. "bytes": q, k, v read and o written once at
    the memory rate; "tensor": 4*B*h*N^2*d operations at the tensor cores'
    bf16 rate (f32: the rate outside them); "exp": the B*h*N^2 exponentials
    at the special-function unit's rate ``exp_per_s``."""
    b, h, n, d = shape
    floors = {"bytes": 4 * b * h * n * d * itemsize / HBM_BYTES_PER_S,
              "tensor": 4 * b * h * n * n * d / (BF16_FLOPS if itemsize == 2 else F32_FLOPS),
              "exp": b * h * n * n / exp_per_s}
    bound_by = max(floors, key=floors.get)
    return floors[bound_by] * 1e3, bound_by


def card_exp_per_s() -> float:
    """The special-function unit's ex2 rate on this card: 16 per clock per SM
    at the maximum SM clock that nvidia-smi reports."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def phase_groupnorm(cfg, card: str, cond_cfg):
    import torch
    import torch.nn.functional as F

    from audio_diffusion_torch.ops import fused_groupnorm as gn

    calls = slice_norm_shapes(cfg)
    if len(calls) != 64:
        fail(f"expected 64 GroupNorm calls per UNet forward, recorded {len(calls)}")
    cond_calls = slice_norm_shapes(cond_cfg)
    if len(cond_calls) != COND_NORMS:
        fail(f"expected {COND_NORMS} GroupNorm calls per conditional UNet forward, recorded {len(cond_calls)}")
    shapes = sorted(set(calls))
    cond_shapes = sorted(set(cond_calls) - set(calls))
    groups = cfg.norm_num_groups
    gen = torch.Generator(device="cuda").manual_seed(0)
    # The latent-256 shapes at batch 1 and 32, then the pixel-256 UNet's two
    # largest slabs (cluster route), a pixel-512 slab (cluster in bf16,
    # reread in f32), and one group of 2 x 640 x 640 (in f32 a 16-CTA cluster
    # whose every CTA holds the most shared memory a plan gives it).
    checks = [(s, groups, (1, 32)) for s in shapes] + [(s, groups, (1, COND_TIMED_BATCH)) for s in cond_shapes] + [
        ((128, 256, 256), groups, (1, 2)), ((256, 256, 256), groups, (2,)), ((128, 512, 512), groups, (1, 2)),
        ((2, 640, 640), 1, (2,))]
    err = {"f32": 0.0, "bf16_ulps": 0.0}
    routes = {}
    n = 0
    for (c, h, w), g, batches in checks:
        for b in batches:
            for dtype in (torch.float32, torch.bfloat16):
                route = gn.launch_plan(c, h, w, g, dtype).route
                routes[route] = routes.get(route, 0) + 1
                for eps in (1e-5, 1e-6):
                    x = (torch.randn((b, c, h, w), generator=gen, device="cuda") * 3 + 1).to(dtype)
                    scale = torch.randn(c, generator=gen, device="cuda")
                    bias = torch.randn(c, generator=gen, device="cuda")
                    y = gn.group_norm_silu(x, scale, bias, g, eps)
                    torch.cuda.synchronize()
                    ref = gn.group_norm_silu_plain(x.float(), scale, bias, g, eps)
                    d = (y.float() - ref).abs()
                    tol = 1e-5 * ref.abs().max().item()
                    what = f"gn C={c} H={h} W={w} G={g} B={b} {dtype} eps={eps} ({route} route)"
                    if dtype == torch.float32:
                        if not d.max().item() <= tol:
                            fail(f"{what}: err {d.max().item()} > {tol}")
                        err["f32"] = max(err["f32"], d.max().item())
                    else:
                        # one bf16 ulp of the f32 result, plus the f32 tolerance for values near 0
                        ulps = (d / (bf16_ulp(ref) + tol)).max().item()
                        if not ulps <= 1.0:
                            fail(f"{what}: {ulps:.3f} ulp > 1")
                        err["bf16_ulps"] = max(err["bf16_ulps"], ulps)
                    if b > 1 and not torch.equal(gn.group_norm_silu(x[:1].contiguous(), scale, bias, g, eps),
                                                 y[:1]):
                        fail(f"{what}: batch row 0 differs alone and inside batch {b}")
                    n += 1
                    del x, y, ref, d
    if set(routes) != {"warp", "block", "cluster", "reread"}:
        fail(f"the checks covered routes {sorted(routes)}, not all four")
    print(f"[gn] ok: {n} checks over {len(checks)} (C,H,W) shapes ({len(cond_shapes)} of them only the conditional "
          f"UNet's), routes {routes}; f32 max err {err['f32']:.3g}, "
          f"bf16 max {err['bf16_ulps']:.3f} ulp; batch rows bitwise independent")

    # Time: the 64 calls of one UNet forward at batch 32, bf16 (eps 1e-5).
    xs = [torch.randn((32, c, h, w), generator=gen, device="cuda").to(torch.bfloat16) for (c, h, w) in calls]
    ps = [torch.randn(c, generator=gen, device="cuda") for (c, _, _) in calls]
    ps16 = [p.to(torch.bfloat16) for p in ps]  # torch's group_norm takes weights of x's dtype

    def kernel():
        return [gn.fused_group_norm_silu(x, p, p, groups, 1e-5) for x, p in zip(xs, ps)]

    def library():  # torch's own pair, two calls: the yardstick, never called by the port
        return [F.silu(F.group_norm(x, groups, p, p, 1e-5)) for x, p in zip(xs, ps16)]

    t = {
        "ms": cuda_time_ms(kernel, 20),
        "graph_ms": graph_time_ms(kernel, 50),
        "plain_ms": cuda_time_ms(lambda: [gn.group_norm_silu_plain(x, p, p, groups, 1e-5)
                                          for x, p in zip(xs, ps)], 20),
        "library_ms": cuda_time_ms(library, 20),
        "library_graph_ms": graph_time_ms(library, 50),
        "bound_ms": bytes_bound_ms(sum(gn_bytes(x) for x in xs)),
    }
    print("[gn] per UNet forward (64 calls, batch 32, bf16), ms: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; bound share of the graph-replayed time {100 * t['bound_ms'] / t['graph_ms']:.1f}%  [{card}]")
    per_shape = []
    for (c, h, w) in shapes:
        x = torch.randn((32, c, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        s = torch.randn(c, generator=gen, device="cuda")
        s16 = s.to(torch.bfloat16)

        def one():
            return gn.fused_group_norm_silu(x, s, s, groups, 1e-5)

        def lib():
            return F.silu(F.group_norm(x, groups, s16, s16, 1e-5))

        per_shape.append((c, h, w, calls.count((c, h, w)), gn.launch_plan(c, h, w, groups, x.dtype).route,
                          cuda_time_ms(one, 50), graph_time_ms(lambda: [one() for _ in range(20)], 10) / 20,
                          cuda_time_ms(lambda: gn.group_norm_silu_plain(x, s, s, groups, 1e-5), 50),
                          graph_time_ms(lambda: [lib() for _ in range(20)], 10) / 20, bytes_bound_ms(gn_bytes(x))))
    print("[gn] per call b32 bf16 (C,H,W,calls,route,kernel_ms,graph_ms,plain_ms,library_graph_ms,bound_ms): "
          + "; ".join(f"{c},{h},{w},{m},{r},{k:.4f},{g:.4f},{p:.4f},{lg:.4f},{bd:.4f}"
                      for c, h, w, m, r, k, g, p, lg, bd in per_shape) + f"  [{card}]")
    t["bound_by"] = "bytes"
    return err, t


def sm_clock_during(fn) -> float:
    """Median SM clock (MHz) that nvidia-smi samples every 20 ms while fn() runs."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "20"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.1)
        fn()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    mhz = sorted(float(x) for x in out.split() if x.replace(".", "", 1).isdigit())
    return mhz[len(mhz) // 2] if mhz else float("nan")


def phase_attention(card: str):
    import torch
    import torch.nn.functional as F

    from audio_diffusion_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(1)
    exp_per_s = card_exp_per_s()
    h = 64

    def heads(b, n, d, dtype):  # (B, N, heads, d) projections seen as (B, heads, N, d), as the UNet passes them
        return [torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2) for _ in range(3)]

    # (N, B, d): every route at d=8, the streamed mma route, and the simt route at d=32 and d=128
    cases = [(n, b, 8) for n in ATTN_CHECK_N for b in (1, 32)] + [(ATTN_STREAM_N, 1, 8)] + [
        (n, 2, d) for d in (32, 128) for n in (4, 17, 256)]
    err = {"f32": 0.0, "bf16": 0.0}
    routes = {}
    for n, b, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            plan = at.attention_plan(n, d, dtype)
            streamed = " streamed" if plan.chunk and plan.chunk < n else ""
            routes.setdefault(plan.route, set()).add(f"{'f32' if dtype == torch.float32 else 'bf16'} d={d} N={n}"
                                                     + streamed)
            q, k, v = heads(b, n, d, dtype)
            o = at.flash_mha(q, k, v)
            torch.cuda.synchronize()
            ref = at.attention_plain(q.float(), k.float(), v.float())
            diff = (o.float() - ref).abs()
            what = f"attention N={n} B={b} d={d} {dtype} ({plan.route} route)"
            if dtype == torch.float32:
                tol = 1e-5 * ref.abs().max().item()
                if not diff.max().item() <= tol:
                    fail(f"{what}: max abs err {diff.max().item()} > {tol}")
            else:
                # P rounded to bf16 before P V (as reference_attention does): up to 2^-8 max|v|; then
                # one bf16 ulp of the result
                slack = 2.0 ** -8 * v.float().abs().max().item() + bf16_ulp(ref)
                if not bool((diff <= slack).all()):
                    fail(f"{what}: max abs err {diff.max().item()} beyond 2^-8 max|v| + 1 ulp")
            key = "f32" if dtype == torch.float32 else "bf16"
            err[key] = max(err[key], diff.max().item())
            if not torch.equal(at.flash_mha(q.contiguous(), k.contiguous(), v.contiguous()), o):
                fail(f"{what}: strided views and contiguous inputs differ")
            if b > 1 and not torch.equal(at.flash_mha(q[:1], k[:1], v[:1]), o[:1]):
                fail(f"{what}: batch row 0 differs alone and inside batch {b}")
            if n == 1 and not torch.equal(o, v):
                fail(f"{what}: one key must give o == v exactly")
            del q, k, v, o, ref, diff
    if set(routes) != {"small", "mma", "simt"}:
        fail(f"the checks covered routes {sorted(routes)}, not all three")
    if not any("streamed" in c for c in routes["mma"]):
        fail("the checks did not cover the mma route's streamed K/V")
    print(f"[attn] ok: {2 * len(cases)} checks (strided views bitwise equal to contiguous, batch rows bitwise "
          f"independent, N=1 gives v); max abs err f32 {err['f32']:.3g}, bf16 {err['bf16']:.3g}")
    for route in ("small", "mma", "simt"):
        print(f"[attn] route {route}: " + ", ".join(sorted(routes[route], key=lambda c: (c.split()[0], int(
            c.split()[1][2:]), int(c.split()[2][2:])))))

    per_n = {}
    for n in ATTN_TIME_N:
        q, k, v = heads(32, n, 8, torch.bfloat16)
        bound, bound_by = attn_bound(tuple(q.shape), q.element_size(), exp_per_s)
        per_n[n] = {
            "route": at.attention_plan(n, 8, q.dtype).route,
            "ms": cuda_time_ms(lambda: at.flash_mha(q, k, v), 50),
            "graph_ms": graph_time_ms(lambda: [at.flash_mha(q, k, v) for _ in range(10)], 10) / 10,
            "plain_ms": cuda_time_ms(lambda: at.attention_plain(q, k, v), 20),
            "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50),
            "library_graph_ms": graph_time_ms(lambda: [F.scaled_dot_product_attention(q, k, v)
                                                       for _ in range(10)], 10) / 10,
            "bound_ms": bound, "bound_by": bound_by,
        }
        if n == max(ATTN_TIME_N):  # the clock the exp bound assumes (its maximum) against the clock under load
            per_n[n]["sm_mhz"] = sm_clock_during(lambda: graph_time_ms(lambda: [at.flash_mha(q, k, v)
                                                                               for _ in range(10)], 60))
        del q, k, v
    n_max = max(ATTN_TIME_N)
    bound_mhz = exp_per_s / EXP_PER_CLOCK_PER_SM / torch.cuda.get_device_properties(0).multi_processor_count / 1e6
    print(f"[attn] SM clock during the N={n_max} kernel: {per_n[n_max]['sm_mhz']:.0f} MHz (median of nvidia-smi "
          f"samples); the exp bound assumes {bound_mhz:.0f} MHz  [{card}]")
    print("[attn] per call b32 bf16 h64 d8 (strided views), ms (route: kernel events / graph, plain, "
          "SDPA events / graph, bound (bound_by), bound share of the graph time): "
          + "; ".join(f"N={n} ({t['route']}): {t['ms']:.4f}/{t['graph_ms']:.4f}, {t['plain_ms']:.4f}, "
                      f"{t['library_ms']:.4f}/{t['library_graph_ms']:.4f}, {t['bound_ms']:.6f} ({t['bound_by']}), "
                      f"{100 * t['bound_ms'] / t['graph_ms']:.1f}%"
                      for n, t in per_n.items())
          + f"; exp rate {exp_per_s:.4g}/s  [{card}]")
    # One UNet forward of the slice: 5 calls at N=4 (2x2) and 1 at N=1 (mid).
    per_forward = {key: 5 * per_n[4][key] + per_n[1][key]
                   for key in ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms", "bound_ms")}
    per_forward["bound_by"] = per_n[4]["bound_by"]
    print("[attn] per UNet forward (5 x N=4 + N=1, b32 bf16), ms: "
          + ", ".join(f"{key} {per_forward[key]:.4f}" for key in ("ms", "graph_ms", "plain_ms", "library_ms",
                                                                 "library_graph_ms", "bound_ms"))
          + f"  [{card}]")
    return err, per_forward


def phase_attention_sweep(card: str):
    """The mma route's CTA size: each choice of warps per CTA (the plan takes
    attention.MMA_WARPS by N) checked against the plain version and timed at
    the pixel UNets' N=256 and N=1024 (b32 bf16 h64 d8, graph-replayed)."""
    import torch

    from audio_diffusion_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(2)
    saved = (at.MMA_WARPS, dict(at._PLANS))
    timed = {n: [torch.randn((32, n, 64, 8), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                 for _ in range(3)] for n in (256, 1024)}
    rows = []
    try:
        for warps in (2, 4, 8):
            at.MMA_WARPS = (warps, warps)
            at._PLANS.clear()
            for n in (17, 1000, ATTN_STREAM_N):
                q, k, v = (torch.randn((2, 64, n, 8), generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(3))
                o = at.flash_mha(q, k, v)
                ref = at.attention_plain(q.float(), k.float(), v.float())
                slack = 2.0 ** -8 * v.float().abs().max().item() + bf16_ulp(ref)
                if not bool(((o.float() - ref).abs() <= slack).all()):
                    fail(f"attention sweep, {warps} warps, N={n}: error beyond 2^-8 max|v| + 1 ulp")
                del q, k, v, o, ref
            rows.append((warps, *(graph_time_ms(lambda: [at.flash_mha(*qkv) for _ in range(10)], 5) / 10
                                  for qkv in timed.values())))
    finally:
        at.MMA_WARPS = saved[0]
        at._PLANS.clear()
        at._PLANS.update(saved[1])
    print("[attn-sweep] mma route, b32 bf16 h64 d8, graph-replayed ms by warps per CTA (N=256, N=1024): "
          + "; ".join(f"{w}: {a:.4f}, {c:.4f}" for w, a, c in rows)
          + f"; the plan takes {saved[0][0]} at N <= {at.MMA_WARPS_SPLIT_N}, else {saved[0][1]}  [{card}]")


def build_pipeline():
    from audio_diffusion_torch.bench import build_latent_pipeline

    return build_latent_pipeline(256, "bfloat16", fused_groupnorm=True, device="cuda", seed=0)


def phase_main(pipe, card: str):
    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize

    counters = (gn.group_norm_silu, at.flash_mha)
    warm = {}
    for b, seed in REQUESTS:  # warm-up: one full request of each batch size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(batch_size=b, steps=STEPS, generator=torch.Generator(device="cuda").manual_seed(seed),
             return_arrays=True)
        torch.cuda.synchronize()
        warm[b] = time.perf_counter() - t0
    if len(pipe._compiled) != len(REQUESTS):
        fail(f"[main] {len(pipe._compiled)} programs captured for {len(REQUESTS)} request signatures")

    for c in counters:
        c.launches = 0
    walls = {}
    for b, seed in REQUESTS:
        before = [c.launches for c in counters]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, audio = pipe(batch_size=b, steps=STEPS, generator=gen, return_arrays=True)
        pcm = pcm16_quantize(audio)
        torch.cuda.synchronize()
        wall = walls[b] = time.perf_counter() - t0
        finite = bool(torch.isfinite(audio).all().item())
        raw_np, pcm_np = raw.cpu().numpy(), pcm.cpu().numpy()
        delta = [c.launches - x for c, x in zip(counters, before)]
        if raw_np.dtype != np.uint8 or raw_np.shape != (b, 256, 256):
            fail(f"request b={b}: bad spectrograms {raw_np.dtype} {raw_np.shape}")
        if not finite:
            fail(f"request b={b}: non-finite audio before quantisation")
        if pcm_np.dtype != np.int16 or not np.abs(pcm_np.astype(np.int32)).max() > 1000:
            fail(f"request b={b}: silent or degenerate int16 audio")
        want = [64 * STEPS, 6 * STEPS]
        if delta != want:
            fail(f"request b={b}: launches (group_norm_silu, flash_mha) {delta}, expected {want}")
        print(f"[main] request batch={b}: {wall:.4f} s wall, a graph replay (warm-up call {warm[b]:.4f} s: an "
              f"eager warm-up, the capture and a replay), "
              f"{b / wall:.4f} samples/s, "
              f"launches group_norm_silu/flash_mha {delta}, audio {tuple(pcm_np.shape)} int16 peak "
              f"{int(np.abs(pcm_np.astype(np.int32)).max())}, spectrogram std {raw_np.std():.3f}  [{card}]")
    launches = {c.__name__: c.launches for c in counters}
    print(f"[main] ok: {len(REQUESTS)} requests at {STEPS} steps; launch counters {launches}")
    return launches, walls


def _http(host: str, port: int, method: str, path: str, body=None):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=600)
    try:
        conn.request(method, path, None if body is None else json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _concurrently(host: str, port: int, bodies: list) -> list:
    """POST every body to /generate at once, one thread each; responses in order."""
    import threading

    out = [None] * len(bodies)

    def post(i):
        out[i] = _http(host, port, "POST", "/generate", bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            fail("[serve] a request did not finish within 900 s")
    for i, (status, _, data) in enumerate(out):
        if status != 200:
            fail(f"[serve] request {bodies[i].get('seed')} answered {status}: {data[:300]!r}")
    return out


def _one_batch_images(server, bodies: list, tier: int, phase: str) -> list:
    """POST ``bodies`` at once as json requests; their uint8 spectrograms, after
    checking that the batcher ran them as one batch of ``tier``."""
    import numpy as np

    host, port = server.address[:2]
    n0 = len(server.batcher.stats)
    out = [np.asarray(json.loads(data)["image"], dtype=np.uint8)
           for _, _, data in _concurrently(host, port, [dict(b, format="json") for b in bodies])]
    got = [(s["n"], s["tier"]) for s in list(server.batcher.stats)[n0:]]
    if got != [(len(bodies), tier)]:
        fail(f"{phase} expected one batch of {len(bodies)} at tier {tier}, the batcher ran {got}")
    return out


def _check_wavs(bodies, responses, mel, phase: str) -> int:
    """Every response an audio/wav of the Mel's rate and full length, not silent; returns the frame count."""
    import io
    import wave

    import numpy as np

    n_frames = (mel.x_res - 1) * mel.hop_length
    for body, (_, ctype, data) in zip(bodies, responses):
        if ctype != "audio/wav":
            fail(f"{phase} seed {body['seed']}: content type {ctype}")
        with wave.open(io.BytesIO(data)) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
            if w.getframerate() != mel.get_sample_rate() or len(pcm) != n_frames:
                fail(f"{phase} seed {body['seed']}: wav of {len(pcm)} frames at {w.getframerate()} Hz")
        if not np.abs(pcm.astype(np.int32)).max() > 1000:
            fail(f"{phase} seed {body['seed']}: silent or degenerate audio")
    return n_frames


def step_noise_ms(batch: int, hw, reps: int = 5) -> dict:
    """Host wall (ms, with a synchronize) to draw the variance noise of a
    ``STEPS``-step request from ``batch`` per-row generators: each row's whole
    chain at once (``step_noises`` under ``ROW_CHAIN_BYTES``), and step by
    step (the budget set to 0)."""
    import torch

    from audio_diffusion_torch.schedulers import common

    shape = (batch, *hw, 1)
    saved = common.ROW_CHAIN_BYTES
    out = {}
    try:
        for name, budget in (("chain", saved), ("per_step", 0)):
            common.ROW_CHAIN_BYTES = budget
            best = float("inf")
            for _ in range(reps):
                gens = [torch.Generator(device="cuda").manual_seed(s) for s in range(batch)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in common.step_noises(shape, STEPS, torch.device("cuda"), gens):
                    pass
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) * 1e3)
            out[name] = best
    finally:
        common.ROW_CHAIN_BYTES = saved
    return out


def f32_models(pipe):
    """The pipeline's UNet and VAE rebuilt in f32 on the same weights: what an
    f32 checkpoint serves."""
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D

    unet = UNet2D(dataclasses.replace(pipe.unet.config, dtype="float32")).to(pipe.device).eval()
    unet.load_state_dict(pipe.unet.state_dict())
    vae = AutoencoderKL(dataclasses.replace(pipe.vqvae.config, dtype="float32")).to(pipe.device).eval()
    vae.load_state_dict(pipe.vqvae.state_dict())
    return unet, vae


def tier_inputs(pipe, seed: int, batch: int):
    """``batch`` rows of the batcher's per-seed noise (seeds ``seed``, ``seed + 1``, ...), on the card."""
    import numpy as np
    import torch

    from audio_diffusion_torch.serving.batcher import _noise_for_seed

    h, w = pipe.sample_hw
    return torch.from_numpy(np.stack([_noise_for_seed(seed + i, h, w, 1) for i in range(batch)])).to(pipe.device)


def cross_tier_drift(pipe, models: dict, seed: int, tiers) -> dict:
    """Where one row's result departs between batch 1 and each batch of
    ``tiers`` (the row's noise the same, the rest other seeds): max abs
    difference of one UNet forward at the first timestep, of the latents after
    ``STEPS`` DDIM steps, and of the uint8 spectrograms, for each ``name:
    (unet, vae)`` of ``models``, with that max relative to the max |value|."""
    import torch

    from audio_diffusion_torch.pipelines.pipeline import LATENT_SCALE, postprocess_images

    x = tier_inputs(pipe, seed, max(tiers))
    schedule = pipe.scheduler.schedule(STEPS)
    out = {}
    for name, (unet, vae) in models.items():
        rows = {}
        with torch.inference_mode():
            for b in (1, *tiers):
                z = x[:b].contiguous()
                for i, t in enumerate(schedule.timesteps):
                    eps = unet(z, torch.full((), int(t), device=pipe.device))
                    if i == 0:
                        first = eps[:1].clone()
                    z = pipe.scheduler.step(eps, int(t), z, schedule)
                rows[b] = (first, z[:1].clone(), postprocess_images(vae.decode(z / LATENT_SCALE))[:1].int())
        for tier in tiers:
            for i, what in enumerate(("first forward", "latents", "uint8")):
                a, b = rows[1][i].float(), rows[tier][i].float()
                d = (a - b).abs().max().item()
                out[f"{name} {what} b{tier}"] = (d, d / max(b.abs().max().item(), 1e-30))
    return out


def batch_probe(fn, x, tier: int) -> dict:
    """Which operations give a row another result in a batch of ``tier`` than
    alone, under the current backend settings: ``fn(x[:tier])`` runs under a
    TorchFunctionMode that re-runs every torch call whose tensor arguments
    and result have ``tier`` rows on row 0 alone (those arguments cut to
    their first row) and compares that with row 0 of the batched result.
    Returns the calls in forward order whose row differs (function, input
    shapes, max difference), and per function the calls, the calls that
    differ and the largest difference. The kernels of ``csrc/`` are not torch
    calls: [gn] and [attn] hold their rows."""
    import torch
    from torch.overrides import TorchFunctionMode

    def rows(a):
        return torch.is_tensor(a) and a.dim() > 0 and a.shape[0] == tier

    per_func, differ = {}, []

    class Probe(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = getattr(func, "__name__", str(func))
            if (rows(out) and any(rows(a) for a in args) and not name.endswith("_") and "item" not in name
                    and "empty" not in name):  # in-place ops, host reads and uninitialised memory are not compared
                try:  # the mode is off in here
                    alone = func(*(a[:1] if rows(a) else a for a in args), **kwargs)
                except RuntimeError:  # a shape argument names the batch (reshape, view, expand): rows move as a block
                    alone = None
                if torch.is_tensor(alone) and alone.shape == out[:1].shape:
                    d = (out[:1].float() - alone.float()).abs().max().item()
                    st = per_func.setdefault(name, {"calls": 0, "differ": 0, "max_diff": 0.0})
                    st["calls"] += 1
                    if d > 0:
                        st["differ"] += 1
                        st["max_diff"] = max(st["max_diff"], d)
                        differ.append((name, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)), d))
            return out

    with torch.inference_mode(), Probe():
        fn(x[:tier].contiguous())
    return {"differ": differ, "per_func": per_func}


def module_probe(model, fn, x, tier: int) -> list:
    """The module-level counterpart of :func:`batch_probe`: ``fn(x[:tier])``
    runs with a forward hook on every submodule of ``model`` that re-runs the
    module on row 0 of its inputs alone (through its own forward, so the f32
    attention blocks pad that row as a lone request's is padded) and compares
    that with row 0 of its batched output. Returns the modules whose row 0
    differs: (name, type, max difference)."""
    import torch

    def rows(a):
        return torch.is_tensor(a) and a.dim() > 0 and a.shape[0] == tier

    differ, inside = [], []

    def hook(name):
        def run(mod, args, out):
            if inside or not (rows(out) and args and rows(args[0])):
                return
            inside.append(name)  # the re-run's own submodules are not compared
            try:
                alone = mod(*(a[:1] if rows(a) else a for a in args))
            finally:
                inside.pop()
            d = (out[:1].float() - alone.float()).abs().max().item()
            if d > 0:
                differ.append((name, type(mod).__name__, d))
        return run

    from audio_diffusion_torch.models.unet2d import SelfAttention2D, Transformer2D
    from audio_diffusion_torch.models.vae import VAEAttention

    # the attention blocks as a whole: inside, their modules see one block of rows, not the batch
    attention = (SelfAttention2D, Transformer2D, VAEAttention)
    blocks = [n + "." for n, m in model.named_modules() if isinstance(m, attention)]
    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if n and not any(n.startswith(b) for b in blocks)]
    try:
        with torch.inference_mode():
            fn(x[:tier].contiguous())
    finally:
        for h in handles:
            h.remove()
    return differ


@contextlib.contextmanager
def without_row_blocks():
    """The port before its f32 repair: every attention block in one call, the
    batch folded into its products' rows (``models.unet2d.in_row_blocks`` made
    the identity)."""
    from audio_diffusion_torch.models import unet2d, vae

    saved = unet2d.in_row_blocks

    def one_call(fn, *rows):
        return fn(*rows)

    unet2d.in_row_blocks = vae.in_row_blocks = one_call
    try:
        yield
    finally:
        unet2d.in_row_blocks = vae.in_row_blocks = saved


def tier_layers(pipe, unet, vae, seed: int, tier: int) -> dict:
    """One UNet forward (the first timestep) and one VAE decode at batch
    ``tier`` on ``unet`` and ``vae``: :func:`batch_probe` of each with the
    attention blocks in one call (the calls whose row depends on the batch),
    and :func:`module_probe` of each as the port runs them."""
    import torch

    from audio_diffusion_torch.pipelines.pipeline import LATENT_SCALE

    x = tier_inputs(pipe, seed, tier)
    t = torch.full((), int(pipe.scheduler.schedule(STEPS).timesteps[0]), device=pipe.device)
    fns = {"unet": (unet, lambda z: unet(z, t)), "decode": (vae, lambda z: vae.decode(z / LATENT_SCALE))}
    with without_row_blocks():
        calls = {what: batch_probe(fn, x, tier) for what, (_, fn) in fns.items()}
    return {what: {"calls": calls[what], "modules": module_probe(model, fn, x, tier)}
            for what, (model, fn) in fns.items()}


def describe_probe(probe: dict) -> str:
    """One line of a :func:`tier_layers` entry: the calls that differ with the
    attention blocks in one call, then the modules that differ as the port runs."""
    calls = probe["calls"]
    checked = sum(v["calls"] for v in calls["per_func"].values())
    if calls["differ"]:
        text = (f"{len(calls['differ'])} of {checked} calls: "
                + "; ".join(f"{n}{list(s)} {d:.3g}" for n, s, d in calls["differ"]))
    else:
        text = f"none of {checked} calls"
    mods = probe["modules"]
    return text + "; as the port runs, modules that differ: " + (
        "; ".join(f"{n} ({k}) {d:.3g}" for n, k, d in mods) if mods else "none")


CONV_BATCHES = (SERVE_TIER, 32)  # [conv]: the served batches the convolution kernel is timed at
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak


def conv_layers(pipe) -> list:
    """Every convolution module of one UNet forward and one VAE decode of
    ``pipe``, in call order: (where, module, the input's shape without its
    batch, its dtype), from forward pre-hooks on one eager batch-1 call. (The
    UNet's f32 conv_out is a functional call, not among them.)"""
    import torch

    seen = []
    h, w = pipe.sample_hw
    z = torch.zeros((1, h, w, pipe.unet.config.in_channels), device="cuda")
    for where, model, call in (("unet", pipe.unet, lambda: pipe.unet(z, torch.full((), 500, device="cuda"))),
                               ("decode", pipe.vqvae, lambda: pipe.vqvae.decode(z))):
        hooks = [m.register_forward_pre_hook(lambda mod, args, where=where: seen.append(
            (where, mod, tuple(args[0].shape[1:]), args[0].dtype))) for m in model.modules()
            if isinstance(m, torch.nn.Conv2d)]
        try:
            with torch.inference_mode():
                call()
        finally:
            for hk in hooks:
                hk.remove()
    return seen


def phase_conv(pipe, card: str) -> dict:
    """[conv] The batch-invariant convolution kernel
    (``csrc/batch_invariant_conv2d.cu``) at every bf16 convolution of one
    UNet forward and one VAE decode of the served pipeline, at batches
    CONV_BATCHES: against F.conv2d in f32 over the same bf16-rounded operands
    (within one bf16 ulp plus 1e-5 * max|ref|, TF32 off), row 0 alone bitwise
    its row in the batch; then per distinct layer the kernel's time (CUDA
    events around eager calls, host gaps in; replayed from a CUDA graph), its
    bound (the larger of 2*M*N*K at 989 TFLOP/s and the f32 weights, x and y
    at 3.35 TB/s), the old cuDNN-off path (what Conv2d ran in the window
    before the kernel: the casts and PyTorch's per-row convolution; events)
    and cuDNN's call on pre-cast operands (the library yardstick, never called
    by the port; events / graph), summed over the forward and the decode."""
    import collections

    import torch
    import torch.nn.functional as F

    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.utils import batch_invariant

    # one timing per distinct layer shape (its first module's weights), counted as often as the shape is called
    every = conv_layers(pipe)
    layers = [(where, (shape, tuple(m.weight.shape), m.stride, m.padding), m) for where, m, shape, dtype in every
              if dtype == torch.bfloat16]
    counts = collections.Counter((where, key) for where, key, _ in layers)
    modules = {}
    for where, key, m in layers:
        modules.setdefault(key, m)
    out = {}
    for b in CONV_BATCHES:
        sums = collections.defaultdict(lambda: [0.0] * 6)
        for (where, key), n in counts.items():
            m, shape = modules[key], key[0]
            g = torch.Generator(device="cuda").manual_seed(b)
            x = torch.randn((b, *shape), generator=g, device="cuda").bfloat16()
            big = x.numel() > 1 << 27
            reps = 2 if big else 10

            def kernel():
                return bic.batch_invariant_conv2d(x, m.weight, m.bias, m.stride, m.padding)

            with torch.inference_mode():
                y = kernel()
                ref = F.conv2d(x.float(), m.weight.bfloat16().float(), m.bias.bfloat16().float(), m.stride,
                               m.padding)
                d = (y.float() - ref).abs()
                if (d / (bf16_ulp(ref) + 1e-5 * ref.abs().max())).max().item() > 1.0:
                    fail(f"[conv] {where} {shape} at batch {b}: the kernel is off the f32 conv by {d.max().item()}")
                if not torch.equal(bic.batch_invariant_conv2d(x[:1], m.weight, m.bias, m.stride, m.padding), y[:1]):
                    fail(f"[conv] {where} {shape}: row 0 alone differs from its row in batch {b}")
                wb, bb = m.weight.bfloat16(), m.bias.bfloat16()
                t = [cuda_time_ms(kernel, reps), graph_time_ms(kernel, reps)]
                torch.backends.cudnn.enabled = False
                try:
                    t.append(cuda_time_ms(lambda: F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), m.stride,
                                                           m.padding), 1 if big else 3))
                finally:
                    torch.backends.cudnn.enabled = True
                t += [cuda_time_ms(lambda: F.conv2d(x, wb, bb, m.stride, m.padding), reps),
                      graph_time_ms(lambda: F.conv2d(x, wb, bb, m.stride, m.padding), reps)]
            cout, cin, kh, kw = m.weight.shape
            flops = 2 * y.numel() * cin * kh * kw
            bound = max(flops / H100_BF16_FLOPS * 1e3, bytes_bound_ms(4 * m.weight.numel() + 2 * x.numel()
                                                                       + 2 * y.numel()))
            t.append(bound)
            for i, v in enumerate(t):
                sums[where][i] += n * v
            plan = bic.conv_plan(cin, cout, y.shape[2], y.shape[3], kh, kw, m.stride[0])
            print(f"[conv]   batch {b} {where} x{n} {shape} -> {cout} k{kh} s{m.stride[0]} (tile {plan.block_m}x"
                  f"{plan.block_n}, split {plan.splits}): kernel {t[0]:.4f} / {t[1]:.4f} ms ({flops / t[1] / 1e9:.1f} "
                  f"TFLOP/s), bound {bound:.4f} ({100 * bound / t[1]:.1f}%), old cuDNN-off {t[2]:.4f}, cuDNN "
                  f"{t[3]:.4f} / {t[4]:.4f}")
        for where, v in sums.items():
            calls = sum(n for (w, _), n in counts.items() if w == where)
            print(f"[conv] {where} at batch {b}, every bf16 convolution summed ({calls} calls): kernel events / graph "
                  f"{v[0]:.4f} / {v[1]:.4f} ms, bound {v[5]:.4f} ({100 * v[5] / v[1]:.1f}% of the "
                  f"graph time), old cuDNN-off path {v[2]:.4f}, cuDNN {v[3]:.4f} / {v[4]:.4f}  [{card}]")
        out[b] = dict(sums)
        # The f32 convolutions keep PyTorch's per-row path in the window: the UNet's conv_out (a functional call over
        # bf16-rounded operands, once per denoise step), the VAE's post_quant_conv and conv_out (once per decode).
        unet_out = pipe.unet.conv_out
        xu = torch.randn((b, unet_out.in_channels, *pipe.sample_hw), device="cuda")
        wu = unet_out.weight.to(pipe.unet.config.compute_dtype).float()
        f32 = [(m, torch.randn((b, *shape), device="cuda")) for where, m, shape, dtype in every
               if dtype == torch.float32 and where == "decode"]
        with torch.inference_mode(), batch_invariant.window():
            t_unet = cuda_time_ms(lambda: F.conv2d(xu, wu, unet_out.bias.float(), padding=1), 5)
            t_decode = sum(cuda_time_ms(lambda m=m, x=x: m(x), 2) for m, x in f32)
        batch_ms = STEPS * (sums["unet"][1] + t_unet) + sums["decode"][1] + t_decode
        out[b]["f32"] = {"unet_conv_out": t_unet, "decode": t_decode, "share_of_convs": (STEPS * t_unet + t_decode)
                         / batch_ms}
        print(f"[conv] the f32 convolutions on PyTorch's per-row path in the window at batch {b} (events): the UNet's "
              f"conv_out {t_unet:.4f} ms a step, the VAE's {len(f32)} (post_quant_conv, conv_out) {t_decode:.4f} ms a "
              f"decode: {100 * out[b]['f32']['share_of_convs']:.1f}% of a {STEPS}-step batch's convolution time "
              f"({batch_ms:.2f} ms, the bf16 ones replayed)  [{card}]")
    torch.cuda.empty_cache()
    return out


TIER_PROBES = (SERVE_TIER, 32)  # [tier]: the batches a row alone is held against
TIER_TIMING_REPS = 5  # [tier]: timed forwards per batch, eager and replayed
TIER_DECODE_REPS = 2  # [tier]: timed VAE decodes per batch


def phase_tier(pipe, card: str) -> dict:
    """The serving contract on the card: a row alone against the same row in
    batches of TIER_PROBES (outside the window: of the first), in the
    pipeline's bf16 and in f32 (its UNet and VAE rebuilt in f32, TF32 off),
    with cuDNN's defaults, with ``cudnn.deterministic`` and inside the
    batcher's window (``utils.batch_invariant.window``: cuDNN off,
    ``cudnn.benchmark`` False). Per setting and dtype (outside the window
    bf16 only, where cuDNN makes any dtype's rows vary): every call and
    module of one UNet forward and of one VAE decode whose row 0 differs
    (tier_layers), the end-to-end drift after STEPS DDIM steps and the decode;
    and per setting and dtype the UNet forward's time at batch 1, 8 and 32
    (CUDA events around eager calls, and replayed from a CUDA graph), in bf16
    the VAE decode's at 8 and 32 (events), and inside the window both again
    with the convolutions as they ran there before the convolution kernel
    (the casts and PyTorch's per-row convolution). Inside the window the
    uint8 spectrograms must not drift in either dtype."""
    from unittest import mock

    import torch

    from audio_diffusion_torch.models import unet2d
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.utils import batch_invariant

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled)
    # the probes call the UNet and the VAE themselves, op by op, and hook every torch call
    models = {"bf16": (pipe.unet, pipe.vqvae), "f32": f32_models(pipe)}
    h, w = pipe.sample_hw
    x = torch.randn((32, h, w, 1), generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    t = torch.full((), 500, device="cuda")  # one timestep for every row, as the pipeline passes it

    def forward_ms(unet):
        with torch.inference_mode():
            return {b: (cuda_time_ms(lambda: unet(x[:b], t), TIER_TIMING_REPS),
                        graph_time_ms(lambda: unet(x[:b], t), TIER_TIMING_REPS))
                    for b in (1, SERVE_TIER, 32)}

    def decode_ms(vae):
        with torch.inference_mode():
            return {b: cuda_time_ms(lambda: vae.decode(x[:b]), TIER_DECODE_REPS) for b in (SERVE_TIER, 32)}

    def times(ms):
        return ", ".join(f"{b}: {e:.4f} / {g:.4f}" for b, (e, g) in ms.items())

    def decode_times(ms):
        return ", ".join(f"{b}: {e:.4f}" for b, e in ms.items())

    out = {}
    try:
        for name, det in (("default", False), ("cudnn.deterministic", True), ("batcher window", False)):
            window = name == "batcher window"
            tiers = TIER_PROBES if window else TIER_PROBES[:1]  # outside the window cuDNN varies already at 8
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, False
            with batch_invariant.window() if window else contextlib.nullcontext():
                enabled = torch.backends.cudnn.enabled
                drift = cross_tier_drift(pipe, models if window else {"bf16": models["bf16"]}, 1000, tiers)
                for dtype, (unet, vae) in models.items():
                    # outside the window f32 is timed only: cuDNN makes every dtype's row vary there
                    layers = {tier: tier_layers(pipe, unet, vae, 1000, tier) for tier in tiers
                              if window or dtype == "bf16"}
                    fwd_ms = forward_ms(unet)
                    out[name, dtype] = {"layers": layers, "fwd_ms": fwd_ms,
                                        "drift": {k: v for k, v in drift.items() if k.startswith(dtype)}}
                    print(f"[tier] {name}, {dtype} (eager; cudnn.enabled {enabled}, benchmark False, deterministic "
                          f"{det}, TF32 off; UNet forward ms, events / graph, at batch {times(fwd_ms)})  [{card}]")
                    if dtype == "bf16":
                        out[name, dtype]["decode_ms"] = decode_ms(vae)
                        print(f"[tier]   {dtype} VAE decode ms (events) at batch "
                              f"{decode_times(out[name, dtype]['decode_ms'])}  [{card}]")
                    if window and dtype == "bf16":  # the window before the convolution kernel, for its yardstick
                        with mock.patch.object(unet2d, "batch_invariant_conv2d", bic.conv2d_plain):
                            out[name, dtype]["fwd_ms_old"] = forward_ms(unet)
                            out[name, dtype]["decode_ms_old"] = decode_ms(vae)
                        print(f"[tier]   {dtype} with the old cuDNN-off convolutions (the casts and PyTorch's per-row "
                              f"convolution, as Conv2d ran them in the window before the kernel): UNet forward ms, "
                              f"events / graph, at batch {times(out[name, dtype]['fwd_ms_old'])}; VAE decode ms at "
                              f"batch {decode_times(out[name, dtype]['decode_ms_old'])}  [{card}]")
                    if window:  # the port before its f32 repair, for the cost of the row blocks
                        with without_row_blocks():
                            out[name, dtype]["fwd_ms_one_call"] = forward_ms(unet)
                        print(f"[tier]   {dtype} with every attention block in one call (before the f32 repair): "
                              f"UNet forward ms, events / graph, at batch "
                              f"{times(out[name, dtype]['fwd_ms_one_call'])}  [{card}]")
                    for tier, probe in layers.items():
                        for what in ("unet", "decode"):
                            print(f"[tier]   {dtype} {what}, row 0 alone against batch {tier}, with the attention "
                                  f"blocks in one call, calls that differ: " + describe_probe(probe[what]))
                    if out[name, dtype]["drift"]:
                        print(f"[tier]   {dtype} end to end (max abs, relative): " + "; ".join(
                            f"{k} {d:.4g} ({r:.3g})" for k, (d, r) in out[name, dtype]["drift"].items()))
                if window:
                    with without_row_blocks():
                        before = cross_tier_drift(pipe, {"f32": models["f32"]}, 1000, TIER_PROBES)
                    out[name, "f32"]["drift_one_call"] = before
                    print("[tier]   f32 end to end with every attention block in one call (before the f32 repair): "
                          + "; ".join(f"{k} {d:.4g} ({r:.3g})" for k, (d, r) in before.items()))
            if window:
                moved = {k: d for k, (d, _) in drift.items() if k.split()[1] == "uint8" and d}
                if moved:
                    fail(f"[tier] inside the batcher's window a row's uint8 spectrogram depends on its batch: {moved}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled = saved
    win, on = out["batcher window", "bf16"], out["default", "bf16"]
    three = "; ".join(
        f"{b}: forward kernel {win['fwd_ms'][b][1]:.4f}, cuDNN on {on['fwd_ms'][b][1]:.4f}, old cuDNN-off "
        f"{win['fwd_ms_old'][b][1]:.4f}; decode kernel {win['decode_ms'][b]:.4f}, cuDNN on {on['decode_ms'][b]:.4f}, "
        f"old cuDNN-off {win['decode_ms_old'][b]:.4f}" for b in (SERVE_TIER, 32))
    print(f"[tier] bf16 three ways (UNet forward ms replayed from a graph; VAE decode ms, events), at batch {three}  "
          f"[{card}]")
    print(f"[tier] ok: inside the batcher's window row 0's uint8 spectrogram is the same alone and in batches "
          f"{TIER_PROBES}, in bf16 and in f32  [{card}]")
    return out


def served_conv_launches(pipe, denoise_steps: int, encodes: bool) -> int:
    """The convolution kernel's launches in one served batch of a bf16
    pipeline: every Conv2d of the UNet once per denoise step, of the VAE's
    decoder once, and of its encoder once when the batch encodes input audio
    (the f32 output convolutions are plain nn.Conv2d and stay off it)."""
    from audio_diffusion_torch.models.unet2d import Conv2d

    def count(module):
        return sum(isinstance(m, Conv2d) for m in module.modules())

    return denoise_steps * count(pipe.unet) + count(pipe.vqvae.decoder) + (count(pipe.vqvae.encoder) if encodes else 0)


def phase_serve(pipe, card: str, save_dir: Path):
    """Save the full-width pipeline in the diffusers layout into ``save_dir``
    (which [bench] serves again), load it through
    ``make_server`` (bf16, fused GroupNorm) and answer concurrent HTTP
    requests: pure generation, audio-to-audio at start_step 25 and eta > 0,
    all at 50 steps. The kernels' counters must show every served batch went
    through both kernels."""
    import base64
    import io
    import wave

    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.serving import make_server

    t0 = time.perf_counter()
    pipe.save_pretrained(str(save_dir))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = make_server(str(save_dir), dtype="bfloat16", fused_groupnorm=True, device="cuda", port=0,
                         max_batch=SERVE_TIER, max_wait_ms=1000, steps=STEPS, allowed_etas=[SERVE_ETA],
                         allowed_start_steps=[SERVE_START_STEP])
    t_load = time.perf_counter() - t0
    served = server.batcher.pipe
    for a, b in ((served.unet, pipe.unet), (served.vqvae, pipe.vqvae)):
        if a.config != b.config:
            fail(f"[serve] loaded config {a.config} differs from the saved {b.config}")
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            fail(f"[serve] the loaded {type(a).__name__} weights differ from the saved ones")
    t0 = time.perf_counter()
    server.batcher.warmup()
    t_warm = time.perf_counter() - t0
    warmed = set(served._compiled)
    n_want = len(server.batcher.tiers) * 2 * 2  # x eta {0, SERVE_ETA} x start_step {0, SERVE_START_STEP}
    if len(warmed) != n_want or not all(p.graphs for p in served._compiled.values()):
        fail(f"[serve] warmup left {len(warmed)} programs, expected {n_want} captured ones")
    print(f"[serve] saved the pipeline in {t_save:.2f} s, loaded it through make_server in {t_load:.2f} s (weights "
          f"and configs equal), warmed tiers {server.batcher.tiers} x eta {{0, {SERVE_ETA}}} x start_step "
          f"{{0, {SERVE_START_STEP}}} in {t_warm:.2f} s: {len(warmed)} programs captured (cuDNN off), "
          f"{sum(p.warmup_seconds for p in served._compiled.values()):.2f} s of eager warm-ups and "
          f"{sum(p.capture_seconds for p in served._compiled.values()):.2f} s of capture, graph pool "
          f"{sum(p.pool_bytes for p in served._compiled.values()) / 2**30:.4f} GiB  [{card}]")

    mel = served.mel
    tt = np.arange(mel.x_res * mel.hop_length) / mel.get_sample_rate()
    clip = sum(np.sin(2 * np.pi * f * tt) * a for f, a in ((196.0, 0.4), (392.0, 0.3), (1318.5, 0.2)))
    clip_b64 = base64.b64encode((clip * 32767 / np.abs(clip).max()).astype(np.int16).tobytes()).decode()
    n_frames = (mel.x_res - 1) * mel.hop_length
    server.start()
    host, port = server.address[:2]
    counters = (gn.group_norm_silu, at.flash_mha, bic.batch_invariant_conv2d)
    try:
        bodies = ([{"seed": 100 + i} for i in range(SERVE_REQUESTS["generate"])]
                  + [{"seed": 200 + i, "start_step": SERVE_START_STEP, "audio_pcm16_base64": clip_b64}
                     for i in range(SERVE_REQUESTS["audio_to_audio"])]
                  + [{"seed": 300 + i, "eta": SERVE_ETA} for i in range(SERVE_REQUESTS["eta"])])
        n_stats = len(server.batcher.stats)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        responses = _concurrently(host, port, bodies)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        batches = list(server.batcher.stats)[n_stats:]
        denoise_steps = sum(s["steps"] for s in batches)
        convs = [served_conv_launches(served, s["steps"], s["steps"] == STEPS - SERVE_START_STEP) for s in batches]
        want = {"group_norm_silu": 64 * denoise_steps, "flash_mha": 6 * denoise_steps,
                "batch_invariant_conv2d": sum(convs)}
        if launches != want:  # a bf16 convolution of a served batch that bypassed the kernel shows here
            fail(f"[serve] launches {launches} over {len(batches)} batches of {denoise_steps} denoise steps in all; "
                 f"expected {want} (convolution kernel per batch {convs})")
        _check_wavs(bodies, responses, mel, "[serve]")
        print(f"[serve] {len(bodies)} concurrent requests over HTTP ({SERVE_REQUESTS}) in {wall:.4f} s: "
              f"{len(bodies) / wall:.4f} requests/s; {len(batches)} batches (n/tier/denoise steps "
              f"{[(s['n'], s['tier'], s['steps']) for s in batches]}); launches {launches} = 64 and 6 per denoise "
              f"step of every batch, the convolution kernel {convs} a batch (once per bf16 convolution of each UNet "
              f"forward, the VAE decode and, for audio-to-audio, the encode); all 200 with {n_frames}-frame wavs  "
              f"[{card}]")

        # The same seed as wav and as json, each alone: the same int16 samples.
        _, _, wav_data = _concurrently(host, port, [{"seed": 7}])[0]
        _, _, json_data = _concurrently(host, port, [{"seed": 7, "format": "json"}])[0]
        with wave.open(io.BytesIO(wav_data)) as w:
            if w.readframes(w.getnframes()) != base64.b64decode(json.loads(json_data)["pcm16_base64"]):
                fail("[serve] the wav and json deliveries of seed 7 carry different samples")

        # A seed re-sent into a batch of the same tier with other companions.
        def images(bodies, tier):
            return _one_batch_images(server, bodies, tier, "[serve]")

        same_tier = {}
        for name, tier, extra in (("eta 0", SERVE_TIER, {}), (f"eta {SERVE_ETA}", 4, {"eta": SERVE_ETA})):
            first = images([dict(extra, seed=1000 + i) for i in range(tier)], tier)
            second = images([dict(extra, seed=1000)] + [dict(extra, seed=2000 + i) for i in range(1, tier)], tier)
            if not np.array_equal(first[0], second[0]):
                fail(f"[serve] {name}: seed 1000 gave another spectrogram at tier {tier} with other companions "
                     f"(max diff {np.abs(first[0].astype(int) - second[0].astype(int)).max()})")
            same_tier[name] = first[0]
        solo = images([{"seed": 1000}], 1)[0]
        if not np.array_equal(solo, same_tier["eta 0"]):
            cross = np.abs(solo.astype(np.int32) - same_tier["eta 0"].astype(np.int32))
            fail(f"[serve] eta 0: seed 1000 alone (tier 1) and at tier {SERVE_TIER} differ: max uint8 diff "
                 f"{cross.max()}, {100 * (cross > 0).mean():.2f}% of pixels")
        if set(served._compiled) != warmed:
            fail(f"[serve] live traffic captured programs warmup missed: {set(served._compiled) - warmed}")
        print(f"[serve] ok: wav and json PCM identical; seed 1000 bitwise the same spectrogram with other companions "
              f"at tier {SERVE_TIER} (eta 0) and tier 4 (eta {SERVE_ETA}), and alone at tier 1 (eta 0) as at tier "
              f"{SERVE_TIER}; every batch a replay of a program warmup captured, none captured after it  [{card}]")
        phase_conv(served, card)
        phase_tier(served, card)

        noise_ms = step_noise_ms(32, served.sample_hw)
        print(f"[serve] per-row step noise of one tier-32 request at {STEPS} steps (host wall with a "
              f"synchronize): whole chains, 32 draws: {noise_ms['chain']:.4f} ms; step by step, {32 * STEPS} "
              f"draws: {noise_ms['per_step']:.4f} ms  [{card}]")

        status, _, data = _http(host, port, "GET", "/healthz")
        health = json.loads(data)
        if status != 200 or health["status"] != "ok":
            fail(f"[serve] /healthz answered {status}: {data[:300]!r}")
        copies = [s["copy_ms"] for s in server.batcher.stats]
        print(f"[serve] /healthz over the last {health['recent_batches']} batches: mean_batch {health['mean_batch']}, "
              f"fill {health['fill']}, p50 {health['p50_latency_s']} s, p95 {health['p95_latency_s']} s, mean_run_s "
              f"{health['mean_run_s']}; the finisher's device-to-host copies on the side stream: mean "
              f"{health['mean_copy_ms']} ms, {sum(copies):.4f} ms over {len(copies)} batches, none of it waited "
              f"for by the worker  [{card}]")
    finally:
        server.stop()
    return launches


# [serve] in f32: one batch at each, seed 1000 among other companions; the largest holds two row blocks of the f32
# attention (tier 32's capture alone took ~28 s of the run's time limit; [tier] holds f32 rows at batches 8 and 32)
F32_SERVE_TIERS = (16, 1)


def phase_serve_f32(pipe, card: str) -> None:
    """[serve] in f32 (Queue 3 item 1): the [main] pipeline saved and reloaded
    through ``make_server(dtype="float32", fused_groupnorm=True)``, tiers up to
    F32_SERVE_TIERS[0], eta 0. Seed 1000 sent in one batch of each of F32_SERVE_TIERS, with
    other companions each time, must give one spectrogram, bitwise. Every
    batch launches 64 GroupNorm+SiLU kernels per denoise step and 6 attention
    kernels per denoise step for each block of ROW_BLOCK rows (f32 attention
    runs in row blocks), twice in a batch that captures its program (the
    eager warm-up, then the replay)."""
    import tempfile

    import numpy as np

    from audio_diffusion_torch.models.unet2d import ROW_BLOCK
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.serving import make_server

    with tempfile.TemporaryDirectory() as d:
        pipe.save_pretrained(d)
        server = make_server(d, dtype="float32", fused_groupnorm=True, device="cuda", port=0,
                             max_batch=F32_SERVE_TIERS[0],
                             max_wait_ms=2000, steps=STEPS)
    served = server.batcher.pipe
    if (served.unet.config.dtype, served.vqvae.config.dtype) != ("float32", "float32"):
        fail(f"[serve] f32: make_server loaded {served.unet.config.dtype} / {served.vqvae.config.dtype}")
    counters = (gn.group_norm_silu, at.flash_mha)
    server.start()
    images, notes = {}, []
    try:
        for tier in F32_SERVE_TIERS:
            programs = set(served._compiled)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            images[tier] = _one_batch_images(
                server, [{"seed": 1000}] + [{"seed": 3000 + 100 * tier + i} for i in range(1, tier)], tier,
                "[serve] f32")[0]
            wall = time.perf_counter() - t0
            new = [served._compiled[k] for k in set(served._compiled) - programs]
            runs = 1 + len(new)
            want = {"group_norm_silu": runs * 64 * STEPS, "flash_mha": runs * 6 * STEPS * -(-tier // ROW_BLOCK)}
            launches = {c.__name__: c.launches for c in counters}
            if launches != want:
                fail(f"[serve] f32 tier {tier}: launches {launches}, expected {want}")
            captured = "; ".join(f"an eager warm-up of {p.warmup_seconds:.4f} s and a capture of "
                                 f"{p.capture_seconds:.4f} s" for p in new)
            notes.append(f"tier {tier} {wall:.4f} s ({captured or 'a replay'}, launches {launches})")
    finally:
        server.stop()
    for tier in F32_SERVE_TIERS[:-1]:
        if not np.array_equal(images[tier], images[1]):
            diff = np.abs(images[tier].astype(np.int32) - images[1].astype(np.int32))
            fail(f"[serve] f32 eta 0: seed 1000 alone (tier 1) and at tier {tier} differ: max uint8 diff "
                 f"{diff.max()}, {100 * (diff > 0).mean():.2f}% of pixels")
    print(f"[serve] f32 ok: make_server(dtype=\"float32\") at {STEPS} steps, eta 0: seed 1000 bitwise the same "
          f"spectrogram at tiers {F32_SERVE_TIERS} with other companions; " + "; ".join(notes) + f"  [{card}]")


def phase_layers(pipe, card: str):
    """Per-layer device times at batch 32 (CUDA events), for the breakdown:
    the stages' modules called one by one, op by op, outside any program."""
    import torch

    from audio_diffusion_torch.pipelines.pipeline import LATENT_SCALE, postprocess_images

    b = 32
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b, 32, 32, 1), generator=gen, device="cuda")
    t = torch.full((), 500, dtype=torch.long, device="cuda")
    sched = pipe.scheduler.schedule(STEPS)
    with torch.inference_mode():
        unet_ms = cuda_time_ms(lambda: pipe.scheduler.step(pipe.unet(x, t), 500, x, sched), 10)
        img = pipe.vqvae.decode(x / LATENT_SCALE)
        vae_ms = cuda_time_ms(lambda: pipe.vqvae.decode(x / LATENT_SCALE), 3)
        post_ms = cuda_time_ms(lambda: postprocess_images(img), 10)
        raw = postprocess_images(img)
        gl = {p: cuda_time_ms(lambda: pipe.mel.images_to_audio(raw, generator=gen, projection=p), 2)
              for p in ("fft", "matmul")}
    print(f"[layers] (the stages called op by op) batch 32 device ms: unet_step {unet_ms:.4f} "
          f"(x{STEPS} = {unet_ms * STEPS:.2f}), "
          f"vae_decode {vae_ms:.4f}, postprocess {post_ms:.4f}, nnls+gl fft {gl['fft']:.4f}, "
          f"nnls+gl matmul {gl['matmul']:.4f}  [{card}]")
    return {"unet_step": unet_ms, "vae_decode": vae_ms, "postprocess": post_ms, "gl": gl}


OUR_KERNELS = ("gn_silu_warp_kernel", "gn_silu_cta_kernel", "mha_small_kernel", "mha_mma_kernel", "mha_simt_kernel")


def request(pipe, path: str, **kw):
    """One call of ``pipe`` on ``path``: "fused" (the default: the request's
    program), "staged" (``fuse = False``: one program per stage) or "eager"
    (op by op, outside any program: ``pipe._uncaptured()``, the path module
    hooks and the profiler see call by call)."""
    pipe.fuse = path != "staged"
    try:
        with pipe._uncaptured() if path == "eager" else contextlib.nullcontext():
            return pipe(**kw)
    finally:
        pipe.fuse = True


def profile_request(pipe, path: str, b: int = 32, seed: int = 104) -> dict:
    """torch.profiler over one request of ``b`` at STEPS steps on ``path``
    (:func:`request`): the wall, the device busy time, the events with device
    time, and the count of each of this repo's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request(pipe, path, batch_size=b, steps=STEPS, generator=gen, return_arrays=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    counts = {name: sum(e.count for e in events if name in e.key) for name in OUR_KERNELS}
    return {"wall_us": wall_us, "busy_us": busy, "idle": 100 - 100 * busy / wall_us, "events": events,
            "counts": counts, "copies": [e for e in prof.key_averages() if e.key == "aten::copy_"]}


def profiled_launches(pipe, path: str):
    """One batch-32 replay on ``path`` ("fused" or "staged") under
    torch.profiler: its credited launches against the kernels the profiler
    counts. The profiler's kernel records come from CUPTI, which can drop a
    few under a burst of graph kernels (seen once: 3,198 of 3,200). So up to
    FUSED_PROFILES profiled replays: a count above the credit fails at once,
    and one of them must see exactly the credit. Returns (credited, seen,
    every attempt's count, the profile)."""
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn

    counters = (gn.group_norm_silu, at.flash_mha)
    want = [64 * STEPS, 6 * STEPS]
    attempts = []
    for _ in range(FUSED_PROFILES):
        before = [c.launches for c in counters]
        p = profile_request(pipe, path)
        credited = [c.launches - x for c, x in zip(counters, before)]
        seen = [sum(v for k, v in p["counts"].items() if k.startswith("gn_silu_")), p["counts"]["mha_small_kernel"]]
        attempts.append(seen)
        if credited != want or any(s > c for s, c in zip(seen, credited)):
            fail(f"[{path}] one batch-32 replay: credited launches {credited}, torch.profiler counted {seen} "
                 f"(gn_silu_*_kernel, mha_small_kernel), expected {want}")
        if seen == credited:
            return credited, seen, attempts, p
    fail(f"[{path}] {FUSED_PROFILES} profiled batch-32 replays: torch.profiler counted {attempts}, never the "
         f"credited {credited}")


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def phase_profile(pipe, card: str) -> dict:
    """torch.profiler over one eager batch-32 request (op by op, outside any
    program: ``pipe._uncaptured()``): device busy share of the wall time and
    the kernels that take the most device time. Returns the profile, for
    [fused] to set the graph's beside."""
    p = profile_request(pipe, "eager")
    wall_us, busy, events = p["wall_us"], p["busy_us"], p["events"]
    print(f"[profile] eager (op by op, pipe._uncaptured()) batch 32, {STEPS} steps, profiled wall "
          f"{wall_us / 1e3:.2f} ms, "
          f"device busy {busy / 1e3:.2f} ms = {100 * busy / wall_us:.2f}% (idle {p['idle']:.2f}%)  [{card}]")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    ours = []
    for name in OUR_KERNELS:
        hits = [e for e in events if name in e.key]
        ms = sum(dev_us(e) for e in hits) / 1e3
        ours.append(f"{name} {ms:.3f} ms / {sum(e.count for e in hits)}x ({ms / STEPS:.4f} ms per UNet forward)")
    print("[profile] this repo's kernels, device time in that request: " + "; ".join(ours))
    print(f"[profile] aten::copy_ in that request: {sum(e.count for e in p['copies'])} calls, "
          f"{sum(dev_us(e) for e in p['copies']) / 1e3:.3f} ms device time  [{card}]")
    return p


def phase_fused(pipe, card: str, eager_profile: dict) -> dict:
    """The fused path against the eager one on the [main] pipeline: for each
    of REQUESTS, an eager request (op by op, ``pipe._uncaptured()``) and a
    graph replay of the program [main]'s warm-up call captured, from one
    generator seed each:
    spectrograms bitwise, audio bitwise or within 1 int16 LSB (the reason
    printed), 64 and 6 launches per denoise step on both paths (the graph's
    credited per replay), no capture; walls, peak memory, the program's
    capture time and graph-pool bytes. Then one batch-32 replay under
    torch.profiler: its credited launches against the kernels the profiler
    counts, and the device idle share beside [profile]'s eager request."""
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize

    counters = (gn.group_norm_silu, at.flash_mha)
    want = [64 * STEPS, 6 * STEPS]
    out = {}
    for b, seed in REQUESTS:
        prog = pipe._compiled.get(pipe.signature(STEPS, 0.0, b, None, False, 0, 0, 0, "none"))
        if prog is None or prog.graphs is None:
            fail(f"[fused] batch {b}: [main]'s requests left no captured program")
        runs = {}
        n_programs = len(pipe._compiled)
        for fuse in (False, True):
            before = [c.launches for c in counters]
            gen = torch.Generator(device="cuda").manual_seed(seed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            raw, audio = request(pipe, "fused" if fuse else "eager", batch_size=b, steps=STEPS, generator=gen,
                                 return_arrays=True)
            torch.cuda.synchronize()
            runs[fuse] = {"raw": raw, "audio": audio, "wall": time.perf_counter() - t0,
                          "peak": torch.cuda.max_memory_allocated() / 2**30,
                          "launches": [c.launches - x for c, x in zip(counters, before)]}
        eager, graph = runs[False], runs[True]
        if len(pipe._compiled) != n_programs:
            fail(f"[fused] batch {b}: the requests captured another program")
        for name, r in runs.items():
            if r["launches"] != want:
                fail(f"[fused] batch {b} {'graph' if name else 'eager'}: launches (group_norm_silu, flash_mha) "
                     f"{r['launches']}, expected {want}")
        if not torch.equal(graph["raw"], eager["raw"]):
            d = (graph["raw"].int() - eager["raw"].int()).abs()
            fail(f"[fused] batch {b}: the graph's spectrograms are not bitwise the eager ones (max uint8 diff "
                 f"{d.max().item()} on {(d > 0).float().mean().item():.3%} of pixels)")
        if torch.equal(graph["audio"], eager["audio"]):
            audio_note = "audio bitwise"
        else:
            lsb = (pcm16_quantize(graph["audio"]).int() - pcm16_quantize(eager["audio"]).int()).abs().max().item()
            if lsb > 1:
                fail(f"[fused] batch {b}: the graph's int16 audio differs from the eager one by {lsb} LSB")
            audio_note = (f"audio within {lsb} int16 LSB (from bitwise spectrograms and one phase: Griffin-Lim's "
                          f"f32 sums rounded in another order in the graph)")
        out[b] = {"eager_s": eager["wall"], "graph_s": graph["wall"], "warmup_s": prog.warmup_seconds,
                  "capture_s": prog.capture_seconds,
                  "pool_bytes": prog.pool_bytes, "eager_peak_gib": eager["peak"], "graph_peak_gib": graph["peak"]}
        print(f"[fused] batch {b}: eager {eager['wall']:.4f} s, graph {graph['wall']:.4f} s "
              f"({eager['wall'] / graph['wall']:.2f}x); its first call's eager warm-up {prog.warmup_seconds:.4f} s, "
              f"capture {prog.capture_seconds:.4f} s in {len(prog.graphs)} "
              f"graph(s), graph pool +{prog.pool_bytes / 2**30:.4f} GiB (reserved); peak allocated "
              f"eager {eager['peak']:.4f} GiB, graph {graph['peak']:.4f} GiB (outside the pool); spectrograms bitwise, "
              f"{audio_note}; "
              f"launches group_norm_silu/flash_mha {graph['launches']} on both paths  [{card}]")

    credited, seen, attempts, p = profiled_launches(pipe, "fused")
    print(f"[fused] ok: one batch-32 replay credited {credited} launches = the profiler's gn_silu_*/mha_small_kernel "
          f"counts {seen} (profiled replays: {attempts}); under torch.profiler graph wall {p['wall_us'] / 1e3:.2f} ms, "
          f"device busy "
          f"{p['busy_us'] / 1e3:.2f} ms (idle {p['idle']:.2f}%) against eager {eager_profile['wall_us'] / 1e3:.2f} "
          f"ms, busy {eager_profile['busy_us'] / 1e3:.2f} ms (idle {eager_profile['idle']:.2f}%); programs "
          f"{len(pipe._compiled)}, pool bytes in all {sum(q.pool_bytes for q in pipe._compiled.values())}  [{card}]")
    return out


def phase_staged(pipe, card: str) -> dict:
    """The staged path and the cached inversion on the [main] pipeline: the
    counterparts of the JAX package's staged programs (``fuse = False``,
    ``return_images_only``) and of its jitted ``encode``.

    - Requests: for each of REQUESTS its first ``fuse = False`` call (one
      eager warm-up and one capture per stage: denoise, vae_decode, audio;
      each stage's seconds and the graph pool's growth), then STAGED_REPS
      calls each of the staged replay, the fused replay ([main]'s program)
      and the eager run, from one generator seed: spectrograms and audio
      bitwise the same on the three, 64 and 6 launches per denoise step on
      each (a replay's credited), the median walls. Then one batch-32 staged
      replay under torch.profiler: its credited launches against the kernels
      the profiler counts.
    - Images only: ``return_images_only=True`` at STAGED_IMAGES_BATCH (the
      denoise and decode stages replayed, nothing captured), its wall, its
      spectrograms bitwise the fused call's.
    - Inversion: ``encode`` of a request's images at each batch of REQUESTS,
      its first call capturing ("vae_encode_mode" and "encode": seconds and
      pool growth), then STAGED_REPS replays and STAGED_REPS eager runs:
      bitwise, each call's launches (64 and 6 per UNet forward, STEPS
      forwards), the median walls; at ROUND_TRIP_BATCH the round trip
      ``pipe(noise=encode(images))`` at STEPS steps, its uint8 MAE against
      the images: a figure, not a gate.

    Returns each kernel's launches over the staged replays and over the
    replayed ``encode`` calls, the counters set to 0 before each."""
    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn

    counters = (gn.group_norm_silu, at.flash_mha)
    want = [64 * STEPS, 6 * STEPS]
    launches = {"staged": [0, 0], "encode": [0, 0]}

    def timed(fn, what: str):
        """fn()'s result and wall; fails unless it launched ``want``."""
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = [c.launches - x for c, x in zip(counters, before)]
        if delta != want:
            fail(f"[staged] {what}: launches (group_norm_silu, flash_mha) {delta}, expected {want}")
        return result, wall

    def first_call(fn, names, what: str):
        """fn()'s first call, which must capture one program per name of ``names``."""
        known = set(pipe._compiled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new = {k: p for k, p in pipe._compiled.items() if k not in known}
        if [k[0] for k in new] != names or not all(p.graphs for p in new.values()):
            fail(f"[staged] {what}: its first call captured {[k[0] for k in new]}, expected {names}")
        stages = "; ".join(f"{k[0]} warm-up {p.warmup_seconds:.4f} s + capture {p.capture_seconds:.4f} s in "
                           f"{len(p.graphs)} graph(s), pool +{p.pool_bytes / 2**30:.4f} GiB" for k, p in new.items())
        return result, wall, sum(p.pool_bytes for p in new.values()), stages

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    out = {"requests": {}, "encode": {}}
    fused_raw = {}
    for b, seed in REQUESTS:
        def call(path):
            return request(pipe, path, batch_size=b, steps=STEPS, generator=gen(seed), return_arrays=True)

        _, first_wall, pool, stages = first_call(lambda: call("staged"), ["denoise", "vae_decode", "audio"],
                                                 f"batch {b}")
        n_programs = len(pipe._compiled)
        walls, results = {}, {}
        for path in ("staged", "fused", "eager"):
            times = []
            for _ in range(STAGED_REPS):
                if path == "staged":
                    for c in counters:
                        c.launches = 0
                results[path], wall = timed(lambda: call(path), f"batch {b} {path}")
                if path == "staged":
                    launches["staged"] = [x + c.launches for x, c in zip(launches["staged"], counters)]
                times.append(wall)
            walls[path] = float(np.median(times))
        if len(pipe._compiled) != n_programs:
            fail(f"[staged] batch {b}: a replay captured another program")
        for other in ("fused", "eager"):
            for i, what in enumerate(("spectrograms", "audio")):
                if not torch.equal(results["staged"][i], results[other][i]):
                    d = (results["staged"][i].double() - results[other][i].double()).abs().max().item()
                    fail(f"[staged] batch {b}: the staged {what} are not bitwise the {other} ones (max diff {d})")
        fused_raw[b] = results["fused"][0]
        out["requests"][b] = {"first_s": first_wall, "pool_bytes": pool, **{f"{k}_s": v for k, v in walls.items()}}
        print(f"[staged] batch {b}: staged replay {walls['staged']:.4f} s, fused replay {walls['fused']:.4f} s, eager "
              f"{walls['eager']:.4f} s (medians of {STAGED_REPS}); spectrograms and audio bitwise on the three, "
              f"launches group_norm_silu/flash_mha {want} per call on each; first staged call {first_wall:.4f} s: "
              f"{stages}  [{card}]")
    credited, seen, attempts, p = profiled_launches(pipe, "staged")
    print(f"[staged] one batch-32 staged replay credited {credited} launches = the profiler's "
          f"gn_silu_*/mha_small_kernel counts {seen} (profiled replays: {attempts}); under torch.profiler wall "
          f"{p['wall_us'] / 1e3:.2f} ms, device busy {p['busy_us'] / 1e3:.2f} ms (idle {p['idle']:.2f}%)  [{card}]")

    b = STAGED_IMAGES_BATCH
    n_programs = len(pipe._compiled)
    images, wall = timed(lambda: pipe(batch_size=b, steps=STEPS, generator=gen(dict(REQUESTS)[b]),
                                      return_images_only=True), f"return_images_only batch {b}")
    if len(pipe._compiled) != n_programs:
        fail(f"[staged] return_images_only batch {b} captured a program: the staged denoise and decode should replay")
    if not (isinstance(images, np.ndarray) and np.array_equal(images, fused_raw[b].cpu().numpy())):
        fail(f"[staged] return_images_only batch {b}: not bitwise the fused call's spectrograms")
    out["images_only_s"] = wall
    print(f"[staged] return_images_only batch {b}: {wall:.4f} s (the denoise and vae_decode stages replayed), "
          f"spectrograms bitwise the fused call's  [{card}]")

    for b, seed in REQUESTS:
        pil = pipe(batch_size=b, steps=STEPS, generator=gen(seed)).images
        first, first_wall, pool, stages = first_call(lambda: pipe.encode(pil, steps=STEPS),
                                                     ["vae_encode_mode", "encode"], f"encode batch {b}")
        walls, results = {}, {}
        for path in ("replay", "eager"):
            times = []
            for _ in range(STAGED_REPS):
                if path == "replay":
                    for c in counters:
                        c.launches = 0
                with pipe._uncaptured() if path == "eager" else contextlib.nullcontext():
                    results[path], wall = timed(lambda: pipe.encode(pil, steps=STEPS), f"encode batch {b} {path}")
                if path == "replay":
                    launches["encode"] = [x + c.launches for x, c in zip(launches["encode"], counters)]
                times.append(wall)
            walls[path] = float(np.median(times))
        if not (torch.equal(first, results["replay"]) and torch.equal(first, results["eager"])):
            d = (first - results["eager"]).abs().max().item()
            fail(f"[staged] encode batch {b}: the replayed inversion is not bitwise the eager one (max diff {d})")
        if not torch.isfinite(first).all():
            fail(f"[staged] encode batch {b}: non-finite noise")
        note = ""
        if b == ROUND_TRIP_BATCH:
            raw, _ = pipe(noise=first, steps=STEPS, return_arrays=True)
            target = np.stack([np.asarray(im) for im in pil]).astype(np.int32)
            mae = float(np.abs(raw.cpu().numpy().astype(np.int32) - target).mean())
            out["round_trip_mae"] = mae
            note = f"; round trip pipe(noise=encode(images)) at {STEPS} steps: uint8 MAE {mae:.4f} against the images"
        out["encode"][b] = {"first_s": first_wall, "pool_bytes": pool, "replay_s": walls["replay"],
                            "eager_s": walls["eager"]}
        print(f"[staged] encode batch {b}: replay {walls['replay']:.4f} s, eager {walls['eager']:.4f} s (medians of "
              f"{STAGED_REPS}), bitwise, launches group_norm_silu/flash_mha {want} per call; first call "
              f"{first_wall:.4f} s: {stages}{note}  [{card}]")
    print(f"[staged] ok: programs {len(pipe._compiled)}, graph pool bytes in all "
          f"{sum(q.pool_bytes for q in pipe._compiled.values())}, reserved {torch.cuda.memory_reserved() / 2**30:.4f} "
          f"GiB  [{card}]")
    out["launches"] = {kind: {c.__name__: n for c, n in zip(counters, v)} for kind, v in launches.items()}
    return out


def phase_unet_reference():
    """One f32 forward of the full-width UNet on the card (kernels, TF32 off)
    against the same weights on the CPU (plain versions)."""
    import torch

    from audio_diffusion_torch.models import UNet2D, unconditional_config

    cfg = unconditional_config(sample_size=(32, 32), fused_groupnorm=True)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 1), generator=torch.Generator().manual_seed(3))
    t = torch.tensor([999, 20])
    with torch.inference_mode():
        ref = unet(x, t)
        out = unet.to("cuda")(x.cuda(), t.cuda()).cpu()
    err = (out - ref).abs().max().item()
    # cuDNN and the CPU convolutions sum in other orders through ~100 layers
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    if not (torch.isfinite(out).all() and err <= tol):
        fail(f"f32 UNet on the card vs CPU: max abs err {err} > {tol}")
    print(f"[ref] ok: f32 UNet forward, card (kernels) vs CPU (plain): max abs err {err:.3g} (tol {tol:.3g})")


def phase_fidelity(pipe, card: str):
    """bench.py's gates as ``audio_diffusion_torch.bench`` holds them: the
    Griffin-Lim round trip through the pipeline's projection (``fft``) and the
    ``matmul`` one, and the bf16 VAE round trip against f32."""
    from audio_diffusion_torch import bench

    mel = pipe.mel
    gl_bound = bench.gl_bound(mel)
    maes = {proj: bench.gl_roundtrip_mae(mel, proj) for proj in ("fft", "matmul")}
    for proj, mae in maes.items():
        if not mae < gl_bound:
            fail(f"GL round-trip MAE ({proj}) {mae:.4f} >= {gl_bound}")
    vae_mae = bench.vae_dtype_mae(pipe.vqvae, mel)
    if not vae_mae < bench.VAE_MAE_BOUND:
        fail(f"bf16 VAE round trip drifted {vae_mae:.4f} uint8-MAE from f32 (bound {bench.VAE_MAE_BOUND})")
    print(f"[fidelity] ok at {mel.y_res}x{mel.x_res} hop {mel.hop_length}: gl_roundtrip_mae fft {maes['fft']:.4f}, "
          f"matmul {maes['matmul']:.4f} (< {gl_bound:.2f}); vae_dtype_mae {vae_mae:.4f} (< "
          f"{bench.VAE_MAE_BOUND:.2f})  [{card}]")
    return maes, vae_mae


# ------------------------------------------------------------- measurement programs

BENCH_RUNS = (  # (name, argv): each program's main(argv), in-process, at full width on the card
    ("bench", []),
    ("bench", ["--latency"]),
    ("stage_ledger", ["--batch", "32"]),
    ("mfu", ["--batch", "32"]),
    ("bench_serving", ["--max_batch", "8", "--clients", "16", "--seconds", "5", "--dtype", "bfloat16"]),
)
BENCH_LEDGER_KEYS = ("noise", f"denoise_scan_{STEPS}_steps", "vae_decode", "postprocess_uint8",
                     "nnls_griffin_lim_x32", "pcm16", "d2h_payload")


def _program_line(name: str, argv: list, **kw) -> dict:
    """``main(argv)`` of one measurement program in-process, its standard
    output captured: exactly one JSON line, which is printed and parsed."""
    import io

    from audio_diffusion_torch import bench
    from audio_diffusion_torch.scripts import bench_serving, mfu, stage_ledger

    main = {"bench": bench.main, "stage_ledger": stage_ledger.main, "mfu": mfu.main,
            "bench_serving": bench_serving.main}[name]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1:
        fail(f"[bench] {name} {argv} printed {len(lines)} lines, not one JSON line: {lines[:3]}")
    print(f"[bench] {name} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    return json.loads(lines[0])


def _need(line: dict, what: str, *paths) -> None:
    """Every dotted path in ``line`` is present and not null, and where it is
    a number, not 0."""
    for path in paths:
        v = line
        for k in path.split("."):
            v = v.get(k) if isinstance(v, dict) else None
        if v is None or (isinstance(v, (int, float)) and not isinstance(v, bool) and v == 0):
            fail(f"[bench] {what}: {path} is {v!r} in {json.dumps(line)[:400]}")


def _on_the_card(line: dict, what: str) -> None:
    import torch

    dev = line["device"]
    if (dev.get("platform") != "gpu" or dev.get("name") != torch.cuda.get_device_name(0)
            or dev.get("count") != torch.cuda.device_count() or not dev.get("power_limit_w")):
        fail(f"[bench] {what} did not run on the card: {dev}")


def phase_bench(pipe, card: str, serve_dir: Path, main_walls) -> dict:
    """The port's measurement programs through their ``main(argv)`` at full
    width on the card: the bench (b32, 50 steps, 5 requests x 3 windows) and
    its ``--latency``, the stage ledger and mfu at batch 32 on the [main]
    pipeline (whose programs they replay where the signature matches), and
    bench_serving on the directory [serve] saved. Every line is checked: on
    the card, no field missing or 0, the gates within their bounds, 3,200
    GroupNorm and 300 attention launches per bench request, mfu in (0, 1.05],
    bench_serving served without a failed request. Returns the kernels'
    launches over the phase."""
    from audio_diffusion_torch import bench
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.scripts import mfu

    counters = (gn.group_norm_silu, at.flash_mha)
    for c in counters:
        c.launches = 0
    t_start = time.perf_counter()
    lines = {}
    for name, argv in BENCH_RUNS:
        what = f"{name} {' '.join(argv)}".strip()
        if name == "bench_serving":
            line = lines[what] = _program_line(name, ["--model", str(serve_dir), *argv])
        else:
            line = lines[what] = _program_line(name, argv, pipe=pipe)
        _on_the_card(line, what)
        if name == "bench":
            _need(line, what, "metric", "value", "unit", "reps", "fidelity.gl_roundtrip_mae", "fidelity.vae_dtype_mae",
                  "setup.first_call_s", "launches.requests", "config.steps", "config.dtype")
            cfg, fid = line["config"], line["fidelity"]
            want = {"batch": 1 if argv else 32, "steps": STEPS, "resolution": [256, 256], "dtype": "bfloat16",
                    "fused_groupnorm": True, "fuse": True}
            if {k: cfg.get(k) for k in want} != want:
                fail(f"[bench] {what}: config {cfg}, expected {want}")
            if not (all(r > 0 for r in line["reps"]) and fid["gl_roundtrip_mae"] < fid["gl_bound"] <= 2.41 + 1.1
                    and fid["vae_dtype_mae"] < bench.VAE_MAE_BOUND
                    and fid["fused_staged_audio_lsb"] <= bench.AUDIO_LSB_BOUND):
                fail(f"[bench] {what}: a window or a gate out of bounds: reps {line['reps']}, fidelity {fid}")
            per = line["launches"]["per_request"]
            if per != {"group_norm_silu": 64.0 * STEPS, "flash_mha": 6.0 * STEPS, "batch_invariant_conv2d": 0.0}:
                fail(f"[bench] {what}: launches per request {per}, expected {64 * STEPS} and {6 * STEPS}, and no "
                     f"convolution kernel outside the batcher's window")
        elif name == "stage_ledger":
            if set(line["ms_per_batch"]) != set(BENCH_LEDGER_KEYS):
                fail(f"[bench] {what}: stages {sorted(line['ms_per_batch'])}, expected {sorted(BENCH_LEDGER_KEYS)}")
            _need(line, what, *(f"ms_per_batch.{k}" for k in BENCH_LEDGER_KEYS), "stage_sum_ms", "fused_e2e_ms",
                  "d2h_payload_mb")
            if not all(v > 0 for v in line["ms_per_batch"].values()) or line["config"]["batch"] != 32:
                fail(f"[bench] {what}: a stage's time is not positive or the batch is not 32: {line}")
        elif name == "mfu":
            _need(line, what, "denoise_scan.gflops", "denoise_scan.ms", "vae_decode.gflops", "vae_decode.ms",
                  "request.ms", "mfu", "peak_tflops")
            shares = [line[k]["mfu"] for k in ("denoise_scan", "vae_decode", "request")] + [line["mfu"]]
            if not all(0 < v <= mfu.MFU_IMPOSSIBLE for v in shares):
                fail(f"[bench] {what}: mfu {shares} out of (0, {mfu.MFU_IMPOSSIBLE}]")
        else:
            _need(line, what, "serving_samples_per_sec", "direct_samples_per_sec", "batching_efficiency", "served",
                  "latency.p50_latency_s")
            if line["failed"] != 0 or line["config"]["direct_programs_made"] != 0:
                fail(f"[bench] {what}: {line['failed']} failed requests, {line['config']['direct_programs_made']} "
                     "programs captured by the direct ceiling")
    launches = {c.__name__: c.launches for c in counters}
    b32, serving = lines["bench"]["value"], lines[what]  # what: the last run, bench_serving
    main_b32 = f"{32 / main_walls[32]:.4f} samples/s ({main_walls[32]:.4f} s)" if main_walls else "not run"
    print(f"[bench] ok in {time.perf_counter() - t_start:.1f} s: bench b32 {b32:.4f} samples/s (best of "
          f"{len(lines['bench']['reps'])} windows, pcm16 and the copy to the host) beside [main]'s b32 replay "
          f"{main_b32}, not gated; latency {lines['bench --latency']['value']:.4f} s; mfu of the request "
          f"{lines['mfu --batch 32']['mfu']:.4f}; served {serving['serving_samples_per_sec']:.4f} samples/s; "
          f"launches over the phase {launches}  [{card}]")
    return launches


# ------------------------------------------------------------ conditional tier

def cond_config():
    """The flagship's UNet: conditional_config at 64x64 latents, 100-d encodings, bf16, fused GroupNorm."""
    from audio_diffusion_torch.models import conditional_config

    return conditional_config((64, 64), cross_attention_dim=100, dtype="bfloat16", fused_groupnorm=True)


def build_cond_pipeline():
    """Conditional-latent-512 at full width: the LDM VAE that takes 512x512 to
    64x64 latents, the cross-attention UNet, Mel 512x512 hop 512, DDIM."""
    import torch

    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, VAEConfig
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    vae_cfg = VAEConfig(sample_size=512, dtype="bfloat16")
    if vae_cfg.latent_hw(512, 512) != cond_config().sample_hw():
        fail(f"the 512 VAE gives {vae_cfg.latent_hw(512, 512)} latents, the UNet takes {cond_config().sample_hw()}")
    vae = AutoencoderKL(vae_cfg).init_params(torch.Generator().manual_seed(11))
    unet = UNet2D(cond_config()).init_params(torch.Generator().manual_seed(10))
    mel = Mel(x_res=512, y_res=512, hop_length=512, device="cuda")
    return AudioDiffusionPipeline(unet, mel, DDIMScheduler(), vae, device="cuda")


def encoder_clips(n: int, seed: int) -> list:
    """``n`` clips of 10 s at 22,050 Hz: three sines of random pitch and level plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(10 * 22050) / 22050
    return [(sum(a * np.sin(2 * np.pi * f * t) for f, a in zip(rng.uniform(110, 1760, 3), rng.uniform(0.1, 0.4, 3)))
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32) for _ in range(n)]


def phase_audio_encoder(card: str):
    """The full-width AudioEncoder (f32, seeded weights, perturbed BatchNorm
    running statistics) encodes the clips on the card; its forward on the
    same mel images is held against the CPU's. Returns the (n, 100) encodings."""
    import copy

    import torch

    from audio_diffusion_torch.models import AudioEncoder

    enc = AudioEncoder().init_params(torch.Generator().manual_seed(12))
    g = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    cpu = copy.deepcopy(enc).eval()
    dev = enc.to("cuda").eval()
    clips = encoder_clips(ENCODER_CLIPS, 14)
    dev.encode(clips)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encodings = dev.encode(clips)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    images = []
    hook = dev.register_forward_pre_hook(lambda mod, args: images.append(args[0]))
    again = dev.encode(clips)
    hook.remove()
    x = images[0]
    if tuple(x.shape) != (ENCODER_CLIPS, 1, 96, 216) or tuple(encodings.shape) != (ENCODER_CLIPS, 100):
        fail(f"AudioEncoder: images {tuple(x.shape)}, encodings {tuple(encodings.shape)}")
    with torch.inference_mode():
        ref = cpu(x.cpu())  # one slice per clip, so the average pool is the row itself
        forward_ms = cuda_time_ms(lambda: dev(x), 20)
    err = (encodings.cpu() - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())  # cuDNN/cuBLAS vs CPU sum order over a 41,472-long dot, TF32 off
    if not (torch.isfinite(encodings).all() and err <= tol and torch.equal(again, encodings)):
        fail(f"AudioEncoder on the card vs CPU: max abs err {err} > {tol} (or not repeatable)")
    print(f"[cond] AudioEncoder (f32, full width, 41,472-wide dense) encoded {ENCODER_CLIPS} clips of 10 s on the card: "
          f"{wall_ms:.4f} ms wall (mel + forward), forward alone {forward_ms:.4f} ms (CUDA events); against the CPU "
          f"forward max abs err {err:.3g} (tol {tol:.3g}); encodings {tuple(encodings.shape)}  [{card}]")
    return encodings


def _cond_encoding(encodings, b: int):
    """(b, 100): row i takes clip i mod n's encoding."""
    return encodings[[i % encodings.shape[0] for i in range(b)]]


def phase_cond(pipe, encodings, card: str):
    """Batch-1 and -16 requests of 50 DDIM steps with the clips' encodings
    through ``__call__``; 44 GroupNorm+SiLU launches and no attention-kernel
    launch per UNet forward. Then one generator, two encodings: two images."""
    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize

    h, w = pipe.mel.y_res, pipe.mel.x_res
    counters = (gn.group_norm_silu, at.flash_mha)
    warm = {}
    for b, seed in COND_REQUESTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(batch_size=b, steps=STEPS, generator=torch.Generator(device="cuda").manual_seed(seed),
             encoding=_cond_encoding(encodings, b), return_arrays=True)
        torch.cuda.synchronize()
        warm[b] = time.perf_counter() - t0

    for c in counters:
        c.launches = 0
    for b, seed in COND_REQUESTS:
        before = [c.launches for c in counters]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        raw, audio = pipe(batch_size=b, steps=STEPS, generator=gen, encoding=_cond_encoding(encodings, b),
                          return_arrays=True)
        pcm = pcm16_quantize(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(audio).all().item())
        raw_np, pcm_np = raw.cpu().numpy(), pcm.cpu().numpy()
        delta = [c.launches - x for c, x in zip(counters, before)]
        if raw_np.dtype != np.uint8 or raw_np.shape != (b, h, w):
            fail(f"[cond] request b={b}: bad spectrograms {raw_np.dtype} {raw_np.shape}")
        if not finite:
            fail(f"[cond] request b={b}: non-finite audio before quantisation")
        if pcm_np.dtype != np.int16 or pcm_np.shape != (b, (w - 1) * pipe.mel.hop_length) or \
                not np.abs(pcm_np.astype(np.int32)).max() > 1000:
            fail(f"[cond] request b={b}: silent or degenerate int16 audio {pcm_np.shape}")
        want = [COND_NORMS * STEPS, 0]
        if delta != want:
            fail(f"[cond] request b={b}: launches (group_norm_silu, flash_mha) {delta}, expected {want}")
        print(f"[cond] request batch={b} with encodings: {wall:.4f} s wall (warm-up call {warm[b]:.4f} s), "
              f"{b / wall:.4f} samples/s, max_memory_allocated {peak_gib:.4f} GiB, launches group_norm_silu/flash_mha "
              f"{delta}, audio {tuple(pcm_np.shape)} int16 peak {int(np.abs(pcm_np.astype(np.int32)).max())}, "
              f"spectrogram std {raw_np.std():.3f}  [{card}]")
    launches = {c.__name__: c.launches for c in counters}

    two = [pipe(batch_size=1, steps=STEPS, generator=torch.Generator(device="cuda").manual_seed(203),
                encoding=encodings[i:i + 1], return_images_only=True)[0].astype(np.int32) for i in (0, 1)]
    diff = np.abs(two[0] - two[1])
    if not diff.any():
        fail("[cond] two encodings gave the same image from one generator: the conditioning is not live")
    print(f"[cond] ok: {len(COND_REQUESTS)} requests at {STEPS} steps, launch counters {launches}; one generator, "
          f"clip 0's and clip 1's encodings: mean |uint8 diff| {diff.mean():.4f}, max {diff.max()}, "
          f"{100 * (diff > 0).mean():.2f}% of pixels differ")
    return launches


def phase_cond_reference(pipe, encodings):
    """One f32 forward of the full-width conditional UNet on the card
    (kernels, TF32 off) against the same weights on the CPU (plain)."""
    import torch

    from audio_diffusion_torch.models import UNet2D

    unet = UNet2D(dataclasses.replace(pipe.unet.config, dtype="float32"))
    unet.load_state_dict(pipe.unet.state_dict(), strict=True)
    h, w = unet.config.sample_hw()
    x = torch.randn((1, h, w, 1), generator=torch.Generator().manual_seed(3))
    t = torch.tensor([500])
    e = encodings[:1, None].cpu()
    with torch.inference_mode():
        ref = unet(x, t, e)
        out = unet.to("cuda")(x.cuda(), t.cuda(), e.cuda()).cpu()
    err = (out - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())  # cuDNN, SDPA and the CPU sum in other orders
    if not (torch.isfinite(out).all() and err <= tol):
        fail(f"[cond] f32 conditional UNet on the card vs CPU: max abs err {err} > {tol}")
    print(f"[cond] ok: f32 conditional UNet forward (batch 1, 64x64), card (kernels, SDPA) vs CPU (plain): max abs "
          f"err {err:.3g} (tol {tol:.3g})")


def sdpa_bound(q, k, exp_per_s: float):
    """(bound ms, bound_by) of one SDPA call: bytes (q, k, v read, o written),
    4*B*h*N*M*d tensor operations, or the B*h*N*M exponentials."""
    b, h, n, d = q.shape
    m = k.shape[2]
    floors = {"bytes": (2 * n + 2 * m) * b * h * d * q.element_size() / HBM_BYTES_PER_S,
              "tensor": 4 * b * h * n * m * d / BF16_FLOPS, "exp": b * h * n * m / exp_per_s}
    bound_by = max(floors, key=floors.get)
    return floors[bound_by] * 1e3, bound_by


def phase_cond_timing(pipe, encodings, card: str) -> dict:
    """The conditional UNet forward at batch 16 (bf16), by CUDA events and
    replayed from a CUDA graph, split into its 44 GroupNorm+SiLU calls, its
    32 SDPA calls (graph-replayed at their shapes) and the rest."""
    import torch
    import torch.nn.functional as F

    from audio_diffusion_torch.ops import fused_groupnorm as gn

    b, cfg = COND_TIMED_BATCH, pipe.unet.config
    norms, transformers = slice_shapes(cfg)
    if len(norms) != COND_NORMS or 2 * len(transformers) != COND_SDPA:
        fail(f"[cond] {len(norms)} norms and {len(transformers)} Transformer2D per forward")
    gen = torch.Generator(device="cuda").manual_seed(8)
    h, w = cfg.sample_hw()
    x = torch.randn((b, h, w, 1), generator=gen, device="cuda")
    t = torch.full((), 500, dtype=torch.long, device="cuda")
    e = _cond_encoding(encodings, b)[:, None]
    bf16 = torch.bfloat16
    with torch.inference_mode():
        fwd = {"ms": cuda_time_ms(lambda: pipe.unet(x, t, e), 10), "graph_ms": graph_time_ms(lambda: pipe.unet(x, t, e), 10)}

        xs = [torch.randn((b, c, hh, ww), generator=gen, device="cuda").to(bf16) for c, hh, ww in norms]
        ps = [torch.randn(c, generator=gen, device="cuda") for c, _, _ in norms]

        def norm_calls():
            return [gn.fused_group_norm_silu(xi, p, p, cfg.norm_num_groups, cfg.norm_eps) for xi, p in zip(xs, ps)]

        gn_t = {"ms": cuda_time_ms(norm_calls, 10), "graph_ms": graph_time_ms(norm_calls, 20),
                "bound_ms": bytes_bound_ms(sum(gn_bytes(xi) for xi in xs))}

        heads = cfg.attention_head_dim
        calls = {}  # N -> [(q, k, v)]: attn1 over N keys, attn2 over the one encoding token
        for c, hh, ww in transformers:
            n, d = hh * ww, c // heads
            for m in (n, 1):
                q = torch.randn((b, n, heads, d), generator=gen, device="cuda").to(bf16).transpose(1, 2)
                k, v = (torch.randn((b, m, heads, d), generator=gen, device="cuda").to(bf16).transpose(1, 2)
                        for _ in range(2))
                calls.setdefault(n, []).append((q, k, v))
        exp_per_s = card_exp_per_s()
        per_n = {}
        for n, qkvs in sorted(calls.items(), reverse=True):
            bounds = [sdpa_bound(q, k, exp_per_s) for q, k, _ in qkvs]
            per_n[n] = {"calls": len(qkvs), "d": qkvs[0][0].shape[-1],
                        "graph_ms": graph_time_ms(lambda: [F.scaled_dot_product_attention(*a) for a in qkvs], 10),
                        "bound_ms": sum(bd for bd, _ in bounds), "bound_by": bounds[0][1]}
        all_qkv = [a for qkvs in calls.values() for a in qkvs]
        sdpa_t = {"ms": cuda_time_ms(lambda: [F.scaled_dot_product_attention(*a) for a in all_qkv], 10),
                  "graph_ms": graph_time_ms(lambda: [F.scaled_dot_product_attention(*a) for a in all_qkv], 10),
                  "bound_ms": sum(v["bound_ms"] for v in per_n.values())}
    rest = fwd["graph_ms"] - gn_t["graph_ms"] - sdpa_t["graph_ms"]
    print(f"[cond] UNet forward, batch {b}, bf16, ms: events {fwd['ms']:.4f}, graph-replayed {fwd['graph_ms']:.4f} = "
          f"{COND_NORMS} GroupNorm+SiLU {gn_t['graph_ms']:.4f} (events {gn_t['ms']:.4f}, bound {gn_t['bound_ms']:.4f}) "
          f"+ {COND_SDPA} SDPA {sdpa_t['graph_ms']:.4f} (events {sdpa_t['ms']:.4f}, bound {sdpa_t['bound_ms']:.4f}) "
          f"+ the rest {rest:.4f}  [{card}]")
    print("[cond] SDPA per forward by query length (calls, head dim, graph-replayed ms, bound ms (bound_by)): "
          + "; ".join(f"N={n}: {v['calls']}, d={v['d']}, {v['graph_ms']:.4f}, {v['bound_ms']:.4f} ({v['bound_by']})"
                      for n, v in per_n.items()) + f"  [{card}]")
    return {"forward": fwd, "gn": gn_t, "sdpa": sdpa_t, "rest_graph_ms": rest}


def phase_cond_serve(pipe, encodings, card: str):
    """Save the conditional pipeline, load it through ``make_server`` (bf16,
    fused GroupNorm, tiers up to 4), and send 4 concurrent HTTP requests with
    distinct encodings: one batch, all 200 with full wavs, 44 GroupNorm+SiLU
    launches per denoise step; then a seed bitwise the same with other companions."""
    import tempfile

    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.serving import make_server

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        pipe.save_pretrained(d)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = make_server(d, dtype="bfloat16", fused_groupnorm=True, device="cuda", port=0,
                             max_batch=COND_SERVE_TIER, max_wait_ms=1000, steps=STEPS)
        t_load = time.perf_counter() - t0
    served = server.batcher.pipe
    for a, b in ((served.unet, pipe.unet), (served.vqvae, pipe.vqvae)):
        sa, sb = a.state_dict(), b.state_dict()
        if a.config != b.config or sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            fail(f"[cond-serve] the loaded {type(a).__name__} differs from the saved one")
    t0 = time.perf_counter()
    server.batcher.warmup()
    t_warm = time.perf_counter() - t0
    rows = [encodings[i].tolist() for i in range(ENCODER_CLIPS)]
    server.start()
    counters = (gn.group_norm_silu, at.flash_mha, bic.batch_invariant_conv2d)
    try:
        bodies = [{"seed": 400 + i, "encoding": [rows[i]]} for i in range(COND_SERVE_TIER)]
        n_stats = len(server.batcher.stats)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        responses = _concurrently(*server.address[:2], bodies)
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        batches = [(s["n"], s["tier"], s["steps"]) for s in list(server.batcher.stats)[n_stats:]]
        if batches != [(COND_SERVE_TIER, COND_SERVE_TIER, STEPS)]:
            fail(f"[cond-serve] the {COND_SERVE_TIER} encoded requests ran as batches {batches}")
        want = {"group_norm_silu": COND_NORMS * STEPS, "flash_mha": 0,
                "batch_invariant_conv2d": served_conv_launches(served, STEPS, False)}
        if launches != want:
            fail(f"[cond-serve] launches {launches}, expected {want}: {COND_NORMS} GroupNorm+SiLU per denoise step, "
                 f"no attention, the convolution kernel once per bf16 convolution of the batch")
        n_frames = _check_wavs(bodies, responses, served.mel, "[cond-serve]")
        first = _one_batch_images(server, [{"seed": 1000 + i, "encoding": [rows[i]]} for i in range(4)], 4,
                                  "[cond-serve]")
        second = _one_batch_images(server, [{"seed": 1000, "encoding": [rows[0]]}] + [
            {"seed": 2000 + i, "encoding": [rows[(i + 2) % 4]]} for i in range(1, 4)], 4, "[cond-serve]")
        if not np.array_equal(first[0], second[0]):
            fail("[cond-serve] seed 1000 with clip 0's encoding gave another spectrogram with other companions")
    finally:
        server.stop()
    print(f"[cond-serve] ok: saved in {t_save:.2f} s, loaded through make_server in {t_load:.2f} s (weights and configs "
          f"equal), warmed tiers {server.batcher.tiers} in {t_warm:.2f} s; {COND_SERVE_TIER} concurrent HTTP requests "
          f"with distinct encodings in {wall:.4f} s as one batch {batches}, all 200 with {n_frames}-frame wavs, "
          f"launches {launches}; seed 1000 bitwise the same spectrogram with other companions and encodings  [{card}]")
    return launches


# ---------------------------------------------------------------- training path

def attn_grad_bound(shape, itemsize: int, exp_per_s: float):
    """(bound ms, bound_by) of one attention backward on q of ``shape``: the
    largest of the bytes (q, k, v, dO read, dq, dk, dv written), the
    10*B*h*N^2*d tensor operations (S = QK^T again, dV, dP, dQ, dK) and the
    B*h*N^2 exponentials of the recomputed softmax."""
    b, h, n, d = shape
    floors = {"bytes": 7 * b * h * n * d * itemsize / HBM_BYTES_PER_S,
              "tensor": 10 * b * h * n * n * d / (BF16_FLOPS if itemsize == 2 else F32_FLOPS),
              "exp": b * h * n * n / exp_per_s}
    bound_by = max(floors, key=floors.get)
    return floors[bound_by] * 1e3, bound_by


def phase_attention_grad(card: str) -> dict:
    """FlashMHA on every route: its forward bitwise a no-grad flash_mha, its
    gradients bitwise autograd through attention_reference on the same
    inputs, and within 1e-5 (f32) or ATTN_GRAD_BF16_BOUND (bf16) of max |ref|
    of the f32 math on the upcast inputs; the backward (recompute and VJP)
    timed by CUDA events and graph-replayed beside SDPA's forward+backward."""
    import torch
    import torch.nn.functional as F

    from audio_diffusion_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(21)
    exp_per_s = card_exp_per_s()
    rows, routes, worst = [], set(), {"float32": 0.0, "bfloat16": 0.0}
    for shape, dtype_name in ATTN_GRAD_CASES:
        dtype = getattr(torch, dtype_name)
        b, h, n, d = shape
        plan = at.attention_plan(n, d, dtype)
        routes.add(plan.route)
        qkv = [torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2) for _ in range(3)]
        dout = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        leaves = [t.detach().requires_grad_(True) for t in qkv]
        before = (at.flash_mha.launches, at.FlashMHA.backwards)
        o = at.FlashMHA.apply(*leaves)
        grads = torch.autograd.grad(o, leaves, dout)
        torch.cuda.synchronize()
        what = f"[attn-grad] {tuple(shape)} {dtype_name} ({plan.route} route)"
        if (at.flash_mha.launches - before[0], at.FlashMHA.backwards - before[1]) != (1, 1):
            fail(f"{what}: one FlashMHA call made {at.flash_mha.launches - before[0]} launches and "
                 f"{at.FlashMHA.backwards - before[1]} backwards")
        with torch.no_grad():
            if not torch.equal(o, at.flash_mha(*qkv)):
                fail(f"{what}: the FlashMHA forward differs from a no-grad flash_mha")
        ref = [t.detach().requires_grad_(True) for t in qkv]
        same = torch.autograd.grad(at.attention_reference(*ref), ref, dout)
        if not all(g.shape == t.shape and g.dtype == dtype and torch.equal(g, s) for g, s, t in zip(grads, same, qkv)):
            fail(f"{what}: gradients differ from autograd through attention_reference")
        up = [t.detach().float().requires_grad_(True) for t in qkv]
        exact = torch.autograd.grad(at.attention_reference(*up), up, dout.float())
        # against the largest gradient of the call: at N=1 dq and dk are 0 in exact arithmetic
        err = max((g.float() - e).abs().max().item() for g, e in zip(grads, exact)) / max(
            e.abs().max().item() for e in exact)
        bound = 1e-5 if dtype == torch.float32 else ATTN_GRAD_BF16_BOUND
        if not err <= bound:
            fail(f"{what}: gradient error {err:.3g} of max |ref| > {bound:.3g}")
        worst[dtype_name] = max(worst[dtype_name], err)

        del o, grads  # nothing of these autograd graphs may stay alive into the captures below

        def backward():  # FlashMHA's backward: fresh leaves, so every node lives on the capturing stream
            lv = [t.detach().requires_grad_(True) for t in qkv]
            return torch.autograd.grad(at.attention_reference(*lv), lv, dout)

        def sdpa():
            lv = [t.detach().requires_grad_(True) for t in qkv]
            return torch.autograd.grad(F.scaled_dot_product_attention(*lv), lv, dout)

        bd, bound_by = attn_grad_bound(shape, dout.element_size(), exp_per_s)
        rows.append({"shape": shape, "dtype": dtype_name, "route": plan.route, "err": err,
                     "ms": cuda_time_ms(backward, 10), "graph_ms": graph_time_ms(backward, 10, side_warmup=True),
                     "library_ms": cuda_time_ms(sdpa, 10),
                     "library_graph_ms": graph_time_ms(sdpa, 10, side_warmup=True),
                     "bound_ms": bd, "bound_by": bound_by})
        del qkv, dout, leaves, same, ref, up, exact
    if routes != {"small", "mma", "simt"}:
        fail(f"[attn-grad] covered routes {sorted(routes)}, not all three")
    print(f"[attn-grad] ok: {len(ATTN_GRAD_CASES)} cases on routes {sorted(routes)}: forward bitwise a no-grad "
          f"flash_mha, gradients bitwise autograd through attention_reference; against the f32 math, max error "
          f"f32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g} of max |ref| (bounds 1e-05, "
          f"{ATTN_GRAD_BF16_BOUND:.3g})")
    print("[attn-grad] backward (recompute + VJP) ms, events / graph, beside SDPA forward+backward events / graph, "
          "bound (bound_by): " + "; ".join(
              f"{r['shape']} {r['dtype']} ({r['route']}): {r['ms']:.4f} / {r['graph_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f} / {r['library_graph_ms']:.4f}, bound {r['bound_ms']:.6f} ({r['bound_by']})"
              for r in rows) + f"  [{card}]")
    # the latent-256 training step's share: per UNet forward 5 calls at N=4 and 1 at N=1, batch 32 bf16
    per = {r["shape"][2]: r for r in rows if r["dtype"] == "bfloat16" and r["shape"][0] == 32}
    return {key: 5 * per[4][key] + per[1][key] for key in ("ms", "graph_ms", "library_ms", "library_graph_ms")}


def write_training_data(root: Path, seed: int = 0) -> Path:
    """TRAIN_SLICES 256x256 PNG spectrograms made by the port's Mel (on the card)
    from seeded chords of sines plus noise; returns their directory."""
    import numpy as np
    from PIL import Image

    from audio_diffusion_torch.mel import Mel

    mel = Mel(x_res=256, y_res=256, hop_length=512, device="cuda")
    rng = np.random.default_rng(seed)
    t = np.arange(mel.slice_size) / mel.get_sample_rate()
    clips = np.stack([sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(
        rng.uniform(80, 2000, 4), rng.uniform(0.05, 0.4, 4), rng.uniform(0, 2 * np.pi, 4)))
        + 0.02 * rng.standard_normal(t.size) for _ in range(TRAIN_SLICES)]).astype(np.float32)
    images = mel.spectrogram_images_from_audio(clips).cpu().numpy()
    out = root / "slices"
    out.mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(out / f"slice_{i:03d}.png")
    return out


def save_training_vae(root: Path) -> Path:
    """A seeded random full-width 256 VAE (f32) in the diffusers layout, as ``--vae`` reads it."""
    import torch

    from audio_diffusion_torch.models import AutoencoderKL, VAEConfig
    from audio_diffusion_torch.utils import diffusers_io

    vae = AutoencoderKL(VAEConfig(sample_size=256)).init_params(torch.Generator().manual_seed(31))
    out = root / "vae"
    diffusers_io.write_json(diffusers_io.vae_config_to_diffusers(vae.config), str(out / "config.json"))
    diffusers_io.save_state_dict(vae, str(out))
    return out


class _LogLines:
    """Collects the training logger's messages."""

    def __init__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.lines.append(record.getMessage())
        self.logger = logging.getLogger("audio_diffusion_torch.training")

    def __enter__(self):
        self.logger.addHandler(self.handler)
        self.logger.setLevel("INFO")
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def phase_train(card: str, root: Path) -> dict:
    """The training slice through ``run_training`` at full width (see the
    module docstring, phase 10). Returns the launch counts of both runs."""
    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.training import RunConfig, TrainConfig, run_training

    t0 = time.perf_counter()
    data = write_training_data(root)
    vae_dir = save_training_vae(root)
    out = root / "model"
    print(f"[train] wrote {TRAIN_SLICES} synthetic 256x256 slices and a seeded 256 VAE (diffusers layout) in "
          f"{time.perf_counter() - t0:.2f} s")
    train = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0, gradient_accumulation_steps=TRAIN_ACCUM)

    def run(max_steps):
        return RunConfig(dataset=str(data), output_dir=str(out), train_batch_size=TRAIN_MICRO, vae=str(vae_dir),
                         mixed_precision="bf16", max_steps=max_steps, save_images_epochs=1000, log_every=1,
                         device="cuda", timing=True)

    counters = (at.flash_mha, gn.group_norm_silu)
    for c in counters:
        c.launches = 0
    at.FlashMHA.backwards = 0
    torch.cuda.synchronize()
    results = []
    with _LogLines() as log:
        for max_steps in (TRAIN_STEPS, TRAIN_RESUME_TO):
            t0 = time.perf_counter()
            results.append(run_training(run(max_steps), train))
            torch.cuda.synchronize()
            results[-1]["wall"] = time.perf_counter() - t0
    peak_gib = step_peak_gib(results)
    launches = {"flash_mha": at.flash_mha.launches, "FlashMHA.backward": at.FlashMHA.backwards,
                "group_norm_silu": gn.group_norm_silu.launches}
    first, second = results
    losses = first["losses"] + second["losses"]
    steps = TRAIN_RESUME_TO
    if not (first["steps"] == TRAIN_STEPS and second["steps"] == steps
            and len(second["losses"]) == steps - TRAIN_STEPS):
        fail(f"[train] runs ended at steps {first['steps']} and {second['steps']} with {len(losses)} losses")
    if not any(f"resumed from step {TRAIN_STEPS}" in line for line in log.lines):
        fail("[train] the second run did not log its resume from the checkpoint")
    if not np.isfinite(losses).all():
        fail(f"[train] non-finite losses {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"[train] the loss did not fall on a fixed small dataset: {losses}")
    want = {"flash_mha": TRAIN_ATTN * TRAIN_ACCUM * steps, "FlashMHA.backward": TRAIN_ATTN * TRAIN_ACCUM * steps,
            "group_norm_silu": 0}
    if launches != want:
        fail(f"[train] launches {launches} over {steps} optimizer steps, expected {want}")

    pipe = AudioDiffusionPipeline.from_pretrained(str(out), dtype="bfloat16", fused_groupnorm=True, device="cuda")
    raw, audio = pipe(batch_size=1, steps=STEPS, generator=torch.Generator(device="cuda").manual_seed(5),
                      return_arrays=True)
    torch.cuda.synchronize()
    if tuple(raw.shape) != (1, 256, 256) or not bool(torch.isfinite(audio).all()):
        fail(f"[train] the trained pipeline answered {tuple(raw.shape)}, "
             f"finite audio {bool(torch.isfinite(audio).all())}")
    del pipe

    tm = {k: first["timings"][k][1:] + second["timings"][k][1:] for k in first["timings"]}  # first steps warm up
    step_ms = float(np.mean(tm["step_ms"]))
    print(f"[train] ok: {steps} steps (micro {TRAIN_MICRO} x accum {TRAIN_ACCUM}, bf16, cached latents, lr "
          f"{TRAIN_LR:g}) through run_training, resumed at {TRAIN_STEPS} (logged), losses "
          f"{np.round(losses, 4).tolist()}:"
          f" mean of the last 3 {np.mean(losses[-3:]):.4f} < first 3 {np.mean(losses[:3]):.4f}; launches {launches} = "
          f"{TRAIN_ATTN} x {TRAIN_ACCUM} per step; the saved pipeline answered a batch-1 request")
    print(f"[train] per step (mean of steps after each run's first): host wall {step_ms:.4f} ms = "
          f"{1e3 / step_ms:.4f} steps/s = {1e3 / step_ms * TRAIN_MICRO * TRAIN_ACCUM:.4f} samples/s; data wait "
          f"{np.mean(tm['data_wait_ms']):.4f} ms, forward+backward {np.mean(tm['fwd_bwd_ms']):.4f} ms, optimizer+EMA "
          f"{np.mean(tm['optimizer_ema_ms']):.4f} ms (CUDA events); run walls {first['wall']:.2f} s and "
          f"{second['wall']:.2f} s; peak allocated in a step {peak_gib:.4f} GiB  [{card}]")
    return launches


def step_peak_gib(results) -> float:
    """The largest of the steps' own peaks (``timings``) over ``run_training`` results, in GiB."""
    return max(b for r in results for b in r["timings"]["peak_allocated_bytes"]) / 2**30


def saved_for_backward_gib(cfg, batch: int, context_len: int = 1) -> dict:
    """What autograd keeps between one training forward of ``cfg`` at ``batch``
    rows and its backward, counted from shapes on the meta device (no memory,
    no compute; runs without a card): the parameters' f32 GiB, the bytes the
    backward reads (``saved``: the tensors saved outside any checkpoint plus,
    with remat, the checkpoints' inputs) and, with remat, the largest block's
    own saved bytes (``recompute``: held while its backward runs). The card's
    attention keeps what a flash kernel keeps: q, k, v, o and an f32
    logsumexp for SDPA, q, k and v for FlashMHA."""
    import unittest.mock

    import torch

    from audio_diffusion_torch.models import UNet2D, unet2d

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):  # (B, N, heads, d), as dot_product_attention takes them
            o = torch.empty_like(q)
            ctx.save_for_backward(q, k, v, o, q.new_empty(q.shape[:3], dtype=torch.float32))
            return o

    class FlashMHA(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return torch.empty_like(q)

    def counter():
        seen, total = set(), [0]

        def pack(t):
            base = t if t._base is None else t._base
            if not isinstance(t, torch.nn.Parameter) and id(base) not in seen:
                seen.add(id(base))
                total[0] += base.numel() * base.element_size()
            return t

        return total, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)

    inputs, blocks = {}, []

    def counted_checkpoint(fn, *args, **kw):
        inputs.update({id(a): a for a in args if isinstance(a, torch.Tensor)})  # held, so no id is reused
        total, hooks = counter()
        with hooks:
            out = fn(*args)
        blocks.append(total[0])
        return out

    with torch.device("meta"):
        unet = UNet2D(cfg).train()
    h, w = cfg.sample_hw()
    x = torch.empty((batch, h, w, cfg.in_channels), device="meta")
    ctx = torch.empty((batch, context_len, cfg.cross_attention_dim), device="meta") if cfg.is_conditional else None
    total, hooks = counter()
    with unittest.mock.patch.object(unet2d, "dot_product_attention", Flash.apply), \
            unittest.mock.patch.object(unet2d, "multi_head_attention", FlashMHA.apply), \
            unittest.mock.patch.object(unet2d, "checkpoint", counted_checkpoint), hooks:
        ((unet(x, torch.tensor(500, device="meta"), ctx) - x) ** 2).mean()
    return {"params_gib": sum(p.numel() for p in unet.parameters()) * 4 / 2**30,
            "saved_gib": (total[0] + sum(a.numel() * a.element_size() for a in inputs.values())) / 2**30,
            "recompute_gib": max(blocks, default=0) / 2**30}


def _logged_steps(lines: list) -> list:
    """The metrics dicts of the training logger's "epoch E step S: {...}" lines, in order."""
    import ast

    return [ast.literal_eval(line.split(": ", 1)[1]) for line in lines
            if line.startswith("epoch ") and " step " in line.split(":", 1)[0]]


def phase_remat(card: str, root: Path) -> dict:
    """UNetConfig.remat on the card (module docstring, phase 11), beside the
    same runs without it. (a) [train]'s pipeline with ``"remat": true`` in its
    unet/config.json through ``run_training(from_pretrained=...)``. (b) The
    conditional-latent-512 UNet at flat batch 16 through make_train_step.
    Returns each kernel's launches in the remat runs."""
    import os
    import shutil

    import numpy as np
    import torch

    from audio_diffusion_torch.models import UNet2D
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training import RunConfig, TrainConfig, run_training
    from audio_diffusion_torch.training.train_unet import init_train_state, make_loss_fn, make_train_step

    t_phase = time.perf_counter()

    def reset():
        gn.group_norm_silu.launches = at.flash_mha.launches = at.FlashMHA.backwards = 0

    def counts():
        return {"flash_mha": at.flash_mha.launches, "FlashMHA.backward": at.FlashMHA.backwards,
                "group_norm_silu": gn.group_norm_silu.launches}

    # (a) latent-256: the flag reaches training only through the pipeline's config, as in the JAX trainer
    seed_dirs = {False: root / "model", True: root / "model_remat"}
    shutil.copytree(seed_dirs[False], seed_dirs[True], ignore=shutil.ignore_patterns("checkpoints", "logs"))
    config_path = seed_dirs[True] / "unet" / "config.json"
    config_path.write_text(json.dumps({**json.loads(config_path.read_text()), "remat": True}))
    train = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0, gradient_accumulation_steps=TRAIN_ACCUM)
    runs = {}
    for remat in (False, True):
        reset()
        t0 = time.perf_counter()
        with _LogLines() as log:
            result = run_training(RunConfig(
                dataset=str(root / "slices"), output_dir=str(root / f"remat_out_{remat}"),
                train_batch_size=TRAIN_MICRO, from_pretrained=str(seed_dirs[remat]), mixed_precision="bf16",
                max_steps=REMAT_STEPS, save_images_epochs=1000, log_every=1, device="cuda", timing=True), train)
            torch.cuda.synchronize()
        logged = _logged_steps(log.lines)
        runs[remat] = {"losses": result["losses"], "grad_norms": [m["grad_norm"] for m in logged],
                       "launches": counts(), "peak_gib": step_peak_gib([result]), "wall": time.perf_counter() - t0,
                       "step_ms": result["timings"]["step_ms"], "fwd_bwd_ms": result["timings"]["fwd_bwd_ms"]}
        if result["steps"] != REMAT_STEPS or len(logged) != REMAT_STEPS:
            fail(f"[remat] latent-256 remat={remat}: {result['steps']} steps, {len(logged)} logged")
    plain, rm = runs[False], runs[True]
    per_step = TRAIN_ATTN * TRAIN_ACCUM
    for remat, forwards in ((False, per_step), (True, 2 * per_step)):  # remat: the forward and the recompute
        want = {"flash_mha": forwards * REMAT_STEPS, "FlashMHA.backward": per_step * REMAT_STEPS,
                "group_norm_silu": 0}
        if runs[remat]["launches"] != want:
            fail(f"[remat] latent-256 remat={remat}: launches {runs[remat]['launches']} over {REMAT_STEPS} steps, "
                 f"expected {want}")
    if rm["losses"][0] != plain["losses"][0]:
        fail(f"[remat] latent-256 step 1's loss {rm['losses'][0]!r} differs from the full-memory run's "
             f"{plain['losses'][0]!r}")
    rel = abs(rm["grad_norms"][0] - plain["grad_norms"][0]) / abs(plain["grad_norms"][0])
    if not rel <= REMAT_GRAD_NORM_RTOL:
        fail(f"[remat] latent-256 step 1's grad_norm {rm['grad_norms'][0]} against {plain['grad_norms'][0]}: "
             f"{rel:.3g} relative (bound {REMAT_GRAD_NORM_RTOL:g})")
    if not np.isfinite(rm["losses"]).all():
        fail(f"[remat] latent-256 non-finite losses {rm['losses']}")

    # the remat run's saved pipeline keeps the flag and answers as a remat=False copy of its weights
    pipe = AudioDiffusionPipeline.from_pretrained(str(root / "remat_out_True"), dtype="bfloat16",
                                                  fused_groupnorm=True, device="cuda")
    if not pipe.unet.config.remat:
        fail("[remat] the pipeline the remat run saved lost remat in its unet/config.json")
    plain_unet = UNet2D(dataclasses.replace(pipe.unet.config, remat=False))
    plain_unet.load_state_dict(pipe.unet.state_dict(), strict=True)
    plain_pipe = AudioDiffusionPipeline(plain_unet, pipe.mel, pipe.scheduler, pipe.vqvae, device="cuda")
    answers = []
    for p in (pipe, plain_pipe):
        reset()
        raw, audio = p(batch_size=REMAT_REQUEST[0], steps=STEPS, return_arrays=True,
                       generator=torch.Generator(device="cuda").manual_seed(REMAT_REQUEST[1]))
        torch.cuda.synchronize()
        answers.append((raw, audio, [gn.group_norm_silu.launches, at.flash_mha.launches],
                        sum(prog.pool_bytes for prog in p._compiled.values())))
    want = [2 * 64 * STEPS, 2 * TRAIN_ATTN * STEPS]  # a first call: the eager warm-up, then the graph's replay
    if not (torch.equal(answers[0][0], answers[1][0]) and torch.equal(answers[0][1], answers[1][1])
            and answers[0][2] == answers[1][2] == want and answers[0][3] == answers[1][3]):
        fail(f"[remat] the saved remat pipeline's batch-{REMAT_REQUEST[0]} request against its remat=False copy: "
             f"spectrograms equal {torch.equal(answers[0][0], answers[1][0])}, audio equal "
             f"{torch.equal(answers[0][1], answers[1][1])}, launches (group_norm_silu, flash_mha) "
             f"{answers[0][2]} and {answers[1][2]}, expected {want}; graph pools {answers[0][3]} and "
             f"{answers[1][3]} bytes")
    pool_bytes = answers[0][3]
    config, state_dict = pipe.unet.config, pipe.unet.state_dict()
    del pipe, plain_pipe, plain_unet, answers

    # One microbatch's forward and backward with and without remat, under deterministic algorithms: the
    # gradients, and the memory the pair adds (the activations remat drops, the gradients). A whole step's peak
    # can be the optimizer's instead: its temporaries reach 4x the parameters, which at latent-256 outweighs
    # the activations of a microbatch of 16.
    g = torch.Generator(device="cuda").manual_seed(7)
    moments = torch.cat([torch.randn((TRAIN_MICRO, 32, 32, 1), generator=g, device="cuda"),
                         torch.full((TRAIN_MICRO, 32, 32, 1), -2.0, device="cuda")], dim=-1)
    t = torch.randint(0, 1000, (TRAIN_MICRO,), generator=g, device="cuda")
    noise, eps = (torch.randn((TRAIN_MICRO, 32, 32, 1), generator=g, device="cuda") for _ in range(2))
    grads = {}
    saved = (torch.are_deterministic_algorithms_enabled(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic workspace, as torch asks
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            unet = UNet2D(dataclasses.replace(config, fused_groupnorm=False, remat=remat))
            unet.load_state_dict(state_dict, strict=True)
            unet = unet.to("cuda").train()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = make_loss_fn(train, unet, DDPMScheduler(), cached_latents=True)(moments, None, t, noise, eps)
            loss.backward()
            grads[remat] = (loss.detach(), {k: p.grad for k, p in unet.named_parameters()},
                            (torch.cuda.max_memory_allocated() - base) / 2**30)
            del unet, loss
    finally:
        torch.use_deterministic_algorithms(saved[0])
        if saved[1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[1]
    grad_diff = max(float((grads[True][1][k].float() - v.float()).abs().max()) for k, v in grads[False][1].items())
    loss_equal = torch.equal(grads[True][0], grads[False][0])
    added = {remat: v[2] for remat, v in grads.items()}
    del grads
    if not added[True] < added[False]:
        fail(f"[remat] latent-256: one microbatch's forward and backward added {added[True]:.4f} GiB with remat, "
             f"{added[False]:.4f} without")

    print(f"[remat] latent-256 through run_training(from_pretrained=<[train]'s pipeline with \"remat\": true in "
          f"unet/config.json>), micro {TRAIN_MICRO} x accum {TRAIN_ACCUM}, bf16, cached latents, {REMAT_STEPS} "
          f"steps, against the same run from the unchanged pipeline: step 1 loss {rm['losses'][0]!r} bitwise the "
          f"full-memory run's; step 1 grad_norm {rm['grad_norms'][0]!r} against {plain['grad_norms'][0]!r} ({rel:.3g} "
          f"relative); launches per step flash_mha {rm['launches']['flash_mha'] // REMAT_STEPS} (2 x {TRAIN_ATTN} x "
          f"{TRAIN_ACCUM}) against {plain['launches']['flash_mha'] // REMAT_STEPS}, FlashMHA.backward "
          f"{rm['launches']['FlashMHA.backward'] // REMAT_STEPS} against "
          f"{plain['launches']['FlashMHA.backward'] // REMAT_STEPS}, group_norm_silu 0  [{card}]")
    for name, r in (("remat", rm), ("full memory", plain)):
        print(f"[remat] latent-256 {name}: losses {np.round(r['losses'], 4).tolist()}; peak allocated in a step "
              f"{r['peak_gib']:.4f} GiB; host wall per step (steps 2-{REMAT_STEPS}) "
              f"{np.mean(r['step_ms'][1:]):.4f} ms, forward+backward {np.mean(r['fwd_bwd_ms'][1:]):.4f} ms (CUDA "
              f"events); run wall {r['wall']:.2f} s  [{card}]")
    print(f"[remat] the remat run's saved pipeline (remat kept in its config) answered a batch-{REMAT_REQUEST[0]} "
          f"request at {STEPS} steps bitwise as a remat=False copy of its weights, launches (group_norm_silu, "
          f"flash_mha) {want} each (warm-up and replay), graph pool {pool_bytes} bytes each  [{card}]")
    shapes = {remat: saved_for_backward_gib(dataclasses.replace(config, fused_groupnorm=False, remat=remat),
                                            TRAIN_MICRO) for remat in (False, True)}
    print(f"[remat] latent-256, one microbatch of {TRAIN_MICRO} (forward and backward, deterministic algorithms): "
          f"loss bitwise {loss_equal}, largest gradient difference {grad_diff!r}; peak allocated above what was "
          f"allocated before it {added[True]:.4f} GiB with remat, {added[False]:.4f} GiB without (activations and "
          f"the f32 gradients); counted from shapes: kept for the backward {shapes[True]['saved_gib']:.4f} GiB "
          f"(+ {shapes[True]['recompute_gib']:.4f} while the largest block recomputes) against "
          f"{shapes[False]['saved_gib']:.4f}, f32 parameters {shapes[False]['params_gib']:.4f} GiB  [{card}]")

    # (b) conditional-latent-512 at the reference's flat batch 16 (GroupNorm kernel off: it has no backward)
    cfg = dataclasses.replace(cond_config(), fused_groupnorm=False)
    h, w = cfg.sample_hw()
    g = torch.Generator().manual_seed(41)
    latents = torch.randn((1, REMAT_COND_BATCH, h, w, cfg.in_channels), generator=g).to("cuda")
    encodings = torch.randn((1, REMAT_COND_BATCH, 1, cfg.cross_attention_dim), generator=g).to("cuda")
    init = UNet2D(cfg).init_params(torch.Generator().manual_seed(40)).state_dict()
    cond_train = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0)
    cond = {}
    for remat in (False, True):
        unet = UNet2D(dataclasses.replace(cfg, remat=remat))
        unet.load_state_dict(init, strict=True)
        unet = unet.to("cuda").train()
        state = init_train_state(cond_train, unet)
        step = make_train_step(cond_train, unet, DDPMScheduler(), conditional=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, events = [], []
        for _ in range(REMAT_COND_STEPS):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            _, m = step(state, latents, encodings, seed=5)
            e[1].record()
            losses.append(m["loss"])
            events.append(e)
        torch.cuda.synchronize()
        cond[remat] = {"losses": [float(x) for x in losses], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "ms": [a.elapsed_time(b) for a, b in events], "launches": counts()}
        del unet, state, step, losses, m
        torch.cuda.empty_cache()
    for remat, r in cond.items():
        shape = saved_for_backward_gib(dataclasses.replace(cfg, remat=remat), REMAT_COND_BATCH)
        print(f"[remat] conditional-latent-512 {'remat' if remat else 'full memory'}: counted from shapes, kept for "
              f"the backward {shape['saved_gib']:.4f} GiB (+ {shape['recompute_gib']:.4f} while the largest block "
              f"recomputes), f32 parameters {shape['params_gib']:.4f} GiB; measured: flat batch "
              f"{REMAT_COND_BATCH}, {h}x{w} latents, cross_attention_dim {cfg.cross_attention_dim}, bf16, "
              f"{REMAT_COND_STEPS} steps through make_train_step: losses {r['losses']!r}; peak allocated "
              f"{r['peak_gib']:.4f} GiB; ms per step (CUDA events) {[round(x, 4) for x in r['ms']]}, steps "
              f"2-{REMAT_COND_STEPS} {np.mean(r['ms'][1:]):.4f}; launches {r['launches']} (Transformer2D runs "
              f"SDPA, GroupNorm is torch's)  [{card}]")
    if cond[True]["losses"][0] != cond[False]["losses"][0] or not cond[True]["peak_gib"] < cond[False]["peak_gib"]:
        fail(f"[remat] conditional-latent-512: step 1 loss {cond[True]['losses'][0]!r} against "
             f"{cond[False]['losses'][0]!r}, peak {cond[True]['peak_gib']:.4f} against {cond[False]['peak_gib']:.4f} "
             "GiB without remat")
    zero = {"flash_mha": 0, "FlashMHA.backward": 0, "group_norm_silu": 0}
    if any(r["launches"] != zero for r in cond.values()):
        fail(f"[remat] conditional-latent-512 launched this repo's kernels: {[r['launches'] for r in cond.values()]}")
    print(f"[remat] ok in {time.perf_counter() - t_phase:.1f} s: with remat, a latent-256 microbatch's forward and "
          f"backward add {added[True]:.4f} against {added[False]:.4f} GiB (the step peak {rm['peak_gib']:.4f} against "
          f"{plain['peak_gib']:.4f}), the conditional-latent-512 b{REMAT_COND_BATCH} step peak is "
          f"{cond[True]['peak_gib']:.4f} against {cond[False]['peak_gib']:.4f} GiB; step 1's loss bitwise in both  "
          f"[{card}]")
    return {"latent256": rm["launches"], "cond512": cond[True]["launches"]}


def phase_train_profile(card: str):
    """torch.profiler over 2 steps of the latent-256 train step (make_train_step,
    bf16, cached-latent moments, micro 16 x accum 2) after 2 warm-up steps:
    the device busy share and the top device operations, and the backward's
    share of the step by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_diffusion_torch.models import UNet2D, unconditional_config
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training.train_unet import TrainConfig, init_train_state, make_train_step

    unet = UNet2D(unconditional_config((32, 32), dtype="bfloat16")).init_params(torch.Generator().manual_seed(0))
    unet = unet.to("cuda").train()
    cfg = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0, gradient_accumulation_steps=TRAIN_ACCUM)
    state = init_train_state(cfg, unet)
    step = make_train_step(cfg, unet, DDPMScheduler(), cached_latents=True, record_events=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    moments = torch.cat([torch.randn((TRAIN_ACCUM, TRAIN_MICRO, 32, 32, 1), generator=g, device="cuda"),
                         torch.full((TRAIN_ACCUM, TRAIN_MICRO, 32, 32, 1), -2.0, device="cuda")], dim=-1)
    for _ in range(2):
        step(state, moments)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, moments)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    print(f"[train] profile of 2 steps: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms = "
          f"{100 * busy / wall_us:.2f}% (idle {100 - 100 * busy / wall_us:.2f}%)  [{card}]")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    ours = [(name, sum(dev_us(e) for e in events if name in e.key) / 1e3) for name in ("mha_small_kernel",)]
    print("[train] this repo's kernels in those 2 steps: " + "; ".join(f"{n} {ms:.3f} ms" for n, ms in ours))

    # one microbatch's forward and backward apart, by CUDA events
    from audio_diffusion_torch.training.train_unet import make_loss_fn

    loss_fn = make_loss_fn(cfg, unet, DDPMScheduler(), cached_latents=True)
    t = torch.randint(0, 1000, (TRAIN_MICRO,), generator=g, device="cuda")
    noise, eps = (torch.randn((TRAIN_MICRO, 32, 32, 1), generator=g, device="cuda") for _ in range(2))
    fwd, bwd = [], []
    for _ in range(4):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss = loss_fn(moments[0], None, t, noise, eps)
        e[1].record()
        loss.backward()
        e[2].record()
        torch.cuda.synchronize()
        fwd.append(e[0].elapsed_time(e[1]))
        bwd.append(e[1].elapsed_time(e[2]))
    print(f"[train] one microbatch of {TRAIN_MICRO} (CUDA events, mean of the last 3 of 4): forward "
          f"{sum(fwd[1:]) / 3:.4f} ms, backward {sum(bwd[1:]) / 3:.4f} ms  [{card}]")
    del state, step, unet
    torch.cuda.empty_cache()


def phase_train_pixel(card: str):
    """The pixel-256 UNet at full width (bf16) takes PIXEL_STEPS steps at batch
    PIXEL_BATCH through make_train_step: 6 flash_mha launches (5 at N=256, 1 at
    N=64, both on the mma route) and 6 FlashMHA backwards per step."""
    import torch

    from audio_diffusion_torch.models import UNet2D, unconditional_config
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training.train_unet import TrainConfig, init_train_state, make_train_step

    unet = UNet2D(unconditional_config((256, 256), dtype="bfloat16")).init_params(torch.Generator().manual_seed(0))
    unet = unet.to("cuda").train()
    cfg = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0)
    state = init_train_state(cfg, unet)
    step = make_train_step(cfg, unet, DDPMScheduler())
    images = torch.rand((1, PIXEL_BATCH, 256, 256, 1), generator=torch.Generator().manual_seed(4)) * 2 - 1
    step(state, images, seed=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (at.flash_mha.launches, at.FlashMHA.backwards, gn.group_norm_silu.launches)
    losses, walls = [], []
    for _ in range(PIXEL_STEPS):
        t0 = time.perf_counter()
        _, m = step(state, images, seed=1)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    delta = (at.flash_mha.launches - before[0], at.FlashMHA.backwards - before[1],
             gn.group_norm_silu.launches - before[2])
    routes = sorted({at.attention_plan(n, 8, torch.bfloat16).route for n in (256, 64)})
    if delta != (6 * PIXEL_STEPS, 6 * PIXEL_STEPS, 0) or routes != ["mma"]:
        fail(f"[train-pixel] launches (flash_mha, FlashMHA.backward, group_norm_silu) {delta}, routes {routes}")
    import numpy as np

    if not np.isfinite(losses).all():
        fail(f"[train-pixel] non-finite losses {losses}")
    print(f"[train-pixel] ok: pixel-256 UNet (bf16, full width) {PIXEL_STEPS} steps at batch {PIXEL_BATCH}: losses "
          f"{np.round(losses, 4).tolist()}, launches (flash_mha, FlashMHA.backward, group_norm_silu) {delta} on the "
          f"mma route; step wall {np.mean(walls):.4f} ms (mean), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.4f} GiB  [{card}]")
    del state, step, unet
    torch.cuda.empty_cache()


def phase_train_vae(card: str, data: Path):
    """The 256 LDM VAE (f32, full width) and its PatchGAN: generator and
    discriminator steps alternate, VAE_TRAIN_STEPS each at batch
    VAE_TRAIN_BATCH from the synthetic slices, ``disc_start`` VAE_DISC_START:
    before it the generator loss is nll + kl_weight * kl and the
    discriminator step leaves its weights as they were; from it on the
    adversarial term is in the loss and the discriminator moves."""
    import numpy as np
    import torch

    from audio_diffusion_torch.data.dataset import ImageSliceDataset, epoch_batches
    from audio_diffusion_torch.models import AutoencoderKL, VAEConfig
    from audio_diffusion_torch.training.train_vae import VAETrainConfig, init_vae_train_state, make_vae_train_steps

    vae = AutoencoderKL(VAEConfig(sample_size=256)).init_params(torch.Generator().manual_seed(41)).to("cuda")
    cfg = VAETrainConfig(learning_rate=1e-5, disc_start=VAE_DISC_START)
    state, disc = init_vae_train_state(cfg, vae)
    gen_step, disc_step = make_vae_train_steps(cfg, vae, disc)
    batches = [b for b, _ in epoch_batches(ImageSliceDataset(str(data)), VAE_TRAIN_BATCH, 1, np.random.default_rng(0))]
    images = [torch.from_numpy(batches[i % len(batches)]).to("cuda") for i in range(2 * VAE_TRAIN_STEPS + 1)]
    gen_step(state, images[-1], seed=0)  # warm-up, then a fresh state
    state, disc = init_vae_train_state(cfg, AutoencoderKL(VAEConfig(sample_size=256)).init_params(
        torch.Generator().manual_seed(41)).to("cuda"))
    gen_step, disc_step = make_vae_train_steps(cfg, state.vae, disc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, walls = [], {"gen": [], "disc": []}
    for i in range(2 * VAE_TRAIN_STEPS):
        kind = "gen" if i % 2 == 0 else "disc"
        before = [p.detach().clone() for p in state.disc.parameters()]
        t0 = time.perf_counter()
        at_step = state.step
        state, m = (gen_step if kind == "gen" else disc_step)(state, images[i], seed=0)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(list(m.values())).all():
            fail(f"[train-vae] step {at_step} ({kind}): non-finite {m}")
        on = at_step >= VAE_DISC_START
        if kind == "gen":
            plain = m["nll"] + cfg.kl_weight * m["kl"]
            if on == (abs(m["loss"] - plain) <= 1e-6 * abs(plain)):
                fail(f"[train-vae] step {at_step}: generator loss {m['loss']} vs nll + kl term {plain} with the "
                     f"adversarial term {'on' if on else 'off'}")
        else:
            moved = not all(torch.equal(a, b) for a, b in zip(before, state.disc.parameters()))
            if moved != on:
                fail(f"[train-vae] step {at_step}: the discriminator {'moved' if moved else 'stayed'} with its "
                     f"term {'on' if on else 'off'}")
        rows.append((at_step, kind, m))
    print(f"[train-vae] ok: 256 LDM VAE (f32, full width) + PatchGAN, batch {VAE_TRAIN_BATCH}, {VAE_TRAIN_STEPS} "
          f"generator and {VAE_TRAIN_STEPS} discriminator steps alternating, the adversarial terms on from step "
          f"{VAE_DISC_START}: " + "; ".join(f"{s} {k} " + ", ".join(f"{n} {v:.4g}" for n, v in m.items())
                                           for s, k, m in rows))
    print(f"[train-vae] step wall ms (mean): generator {np.mean(walls['gen']):.4f}, discriminator "
          f"{np.mean(walls['disc']):.4f}; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB  "
          f"[{card}]")
    del state, disc, vae
    torch.cuda.empty_cache()


# ------------------------------------------------- the convenience layer and data path

def synth_audio(num_samples: int, sr: int = 22050, seed: int = 0):
    """Deterministic harmonic-rich test signal (chord + AM + noise floor): the
    signal of tests/conftest.py::synth_audio, which made tests/goldens/mel_goldens.npz."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(num_samples) / sr
    audio = np.zeros(num_samples, dtype=np.float64)
    for f0, amp in [(220.0, 0.5), (277.2, 0.35), (330.0, 0.3), (440.0, 0.2), (880.0, 0.1)]:
        audio += amp * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    audio *= 0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t)
    audio += 0.001 * rng.standard_normal(num_samples)
    return (audio / np.max(np.abs(audio)) * 0.8).astype(np.float32)


def click_track(bpm: float, seconds: float, sr: int = 22050):
    """Decaying noise bursts on the beat grid over a quiet 220 Hz tone (tests/test_beat_stitch.py::click_track)."""
    import numpy as np

    n = int(seconds * sr)
    audio = np.zeros(n, dtype=np.float32)
    period = int(60 / bpm * sr)
    rng = np.random.default_rng(0)
    burst = (rng.standard_normal(800) * np.exp(-np.arange(800) / 120)).astype(np.float32)
    for start in range(0, n - 800, period):
        audio[start : start + 800] += burst
    audio += 0.05 * np.sin(2 * np.pi * 220 * np.arange(n) / sr).astype(np.float32)
    return audio


class _CountedPipe:
    """A pipeline whose every call must run STEPS - start_step denoise steps
    and launch the GroupNorm+SiLU kernel 64 times and flash_mha 6 times per
    denoise step, once more for a call that captures its program (the
    capture's eager warm-up); each call's wall time, the shape of its
    raw_audio and its generator's state are kept."""

    def __init__(self, pipe, name: str):
        self.pipe, self.name, self.calls = pipe, name, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, **kw):
        import numpy as np
        import torch

        from audio_diffusion_torch.ops import attention as at
        from audio_diffusion_torch.ops import fused_groupnorm as gn

        gen = kw.get("generator")
        state = gen.get_state() if gen is not None else None
        before, n_programs = (gn.group_norm_silu.launches, at.flash_mha.launches), len(self.pipe._compiled)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.pipe(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = (kw.get("steps") or self.pipe.get_default_steps()) - kw.get("start_step", 0)
        runs = 1 + len(self.pipe._compiled) - n_programs
        delta = (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1])
        if f != STEPS - kw.get("start_step", 0) or delta != (64 * f * runs, 6 * f * runs):
            fail(f"[apps] {self.name}: {f} denoise steps, {runs - 1} captures, with launches (group_norm_silu, "
                 f"flash_mha) {delta}; expected {STEPS - kw.get('start_step', 0)} steps and 64 and 6 launches per "
                 f"step, once more for a capture's warm-up")
        raw = kw.get("raw_audio")
        self.calls.append({"wall": wall, "steps": f, "runs": runs, "state": state,
                           "raw_audio": None if raw is None else np.asarray(raw).shape})
        return out


def phase_apps(pipe, card: str) -> dict:
    """The convenience layer at full width on the latent-256 pipeline, saved
    in the diffusers layout and loaded through ``AudioDiffusion(dir,
    dtype="bfloat16", fused_groupnorm=True)``: a generation, an audio-to-audio
    generation with a 1 s mask, ``loop_it``, ``outpaint``, serial and parallel
    ``remix`` and the app callback. Returns the kernels' launches on this path."""
    import functools
    import io
    import tempfile
    import wave

    import numpy as np
    import torch

    from audio_diffusion_torch import apps
    from audio_diffusion_torch.audio_diffusion import AudioDiffusion
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines import stitch

    sr = pipe.mel.get_sample_rate()
    gen_len = (pipe.mel.x_res - 1) * pipe.mel.hop_length  # samples of one generated window
    slice_size = pipe.mel.x_res * pipe.mel.hop_length
    overlap = int(APPS_OVERLAP_SECS * sr)
    stride = slice_size - overlap
    counters = (gn.group_norm_silu, at.flash_mha)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def check_audio(name, audio, length):
        if np.asarray(audio).shape != (length,) or not np.isfinite(audio).all():
            fail(f"[apps] {name}: audio {np.asarray(audio).shape}, expected ({length},) and finite")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        pipe.save_pretrained(d)
        ad = AudioDiffusion(d, dtype="bfloat16", fused_groupnorm=True, device="cuda")
        t_load = time.perf_counter() - t0
        if not (ad.pipe.unet.config.fused_groupnorm and ad.pipe.unet.config.dtype == "bfloat16"):
            fail(f"[apps] AudioDiffusion loaded {ad.pipe.unet.config}")
        ad.pipe = counted = _CountedPipe(ad.pipe, "AudioDiffusion")
        counted(batch_size=1, steps=STEPS, generator=gen(0), return_arrays=True)  # warm-up
        for c in counters:
            c.launches = 0
        walls = {}

        image, (sr_out, audio) = ad.generate_spectrogram_and_audio(steps=STEPS, generator=gen(401))
        walls["generate"] = counted.calls[-1]["wall"]
        if image.size != (256, 256) or sr_out != sr:
            fail(f"[apps] generate: image {image.size}, sample rate {sr_out}")
        check_audio("generate", audio, gen_len)
        clip = synth_audio(slice_size, seed=5)
        image2, (_, audio2) = ad.generate_spectrogram_and_audio_from_audio(raw_audio=clip, steps=STEPS,
                                                                          mask_start_secs=1.0, generator=gen(402))
        walls["audio-to-audio, 1 s mask"] = counted.calls[-1]["wall"]
        check_audio("audio-to-audio", audio2, gen_len)

        t0 = time.perf_counter()
        clicks = click_track(120, 6.0, sr)
        loop = AudioDiffusion.loop_it(clicks, sr)
        walls["loop_it, click track"] = time.perf_counter() - t0
        bars = None if loop is None or len(loop) % 12 else len(loop) / 12 / (2 * sr)  # a 4-beat bar is 2 s
        if bars is None or round(bars) < 1 or abs(bars - round(bars)) > 0.05:
            fail(f"[apps] loop_it on a 120 bpm click track gave {None if loop is None else len(loop)} samples, "
                 f"expected 12 loops of whole 2 s bars")
        generated_loop = AudioDiffusion.loop_it(audio, sr)

        initial = synth_audio(6 * sr, seed=6)
        t0 = time.perf_counter()
        n0 = len(counted.calls)
        out = stitch.outpaint(counted, initial, APPS_OUTPAINT_WINDOWS, overlap_secs=APPS_OVERLAP_SECS,
                              steps=STEPS, generator=gen(403))
        walls["outpaint"] = time.perf_counter() - t0
        check_audio("outpaint", out, len(initial) + APPS_OUTPAINT_WINDOWS * (gen_len - overlap))
        if len(counted.calls) - n0 != APPS_OUTPAINT_WINDOWS:
            fail(f"[apps] outpaint made {len(counted.calls) - n0} calls")

        track = synth_audio(APPS_REMIX_WINDOWS * stride + 1000, seed=7)
        remix_len = gen_len + (APPS_REMIX_WINDOWS - 1) * (gen_len - overlap)
        n0 = len(counted.calls)
        t0 = time.perf_counter()
        serial = stitch.remix(counted, track, start_step=APPS_REMIX_START, overlap_secs=APPS_OVERLAP_SECS,
                              steps=STEPS, generator=gen(404))
        walls["remix, serial"] = time.perf_counter() - t0
        check_audio("serial remix", serial, remix_len)
        remix_calls = counted.calls[n0:]
        if len(remix_calls) != APPS_REMIX_WINDOWS or any(not torch.equal(c["state"], remix_calls[0]["state"])
                                                        for c in remix_calls):
            fail(f"[apps] serial remix: {len(remix_calls)} calls, or not every window from the pinned state")
        _, (_, first) = counted(batch_size=1, raw_audio=track[:slice_size], start_step=APPS_REMIX_START,
                                steps=STEPS, generator=gen(404), return_dict=False)
        if not np.array_equal(serial[:gen_len], first[0]):
            fail(f"[apps] serial remix's first window differs from a direct call with the same generator state: "
                 f"max abs diff {np.abs(serial[:gen_len] - first[0]).max()}")

        n0 = len(counted.calls)
        t0 = time.perf_counter()
        parallel = stitch.remix(counted, track, start_step=APPS_REMIX_START, overlap_secs=APPS_OVERLAP_SECS,
                                steps=STEPS, generator=gen(405), parallel=True)
        walls["remix, parallel"] = time.perf_counter() - t0
        check_audio("parallel remix", parallel, remix_len)
        if [c["raw_audio"] for c in counted.calls[n0:]] != [(APPS_REMIX_WINDOWS, slice_size)]:
            fail(f"[apps] parallel remix calls {[c['raw_audio'] for c in counted.calls[n0:]]}, expected one of "
                 f"{APPS_REMIX_WINDOWS} rows")

        factory = functools.partial(AudioDiffusion, dtype="bfloat16", fused_groupnorm=True)
        apps._cache.clear()
        t0 = time.perf_counter()
        model = apps.get_model(d, factory, device="cuda")
        t_app_load = time.perf_counter() - t0
        model.pipe = app_counted = _CountedPipe(model.pipe, "apps")
        t0 = time.perf_counter()
        image3, (sr3, audio3), (_, loop3) = apps.generate_spectrogram_audio_and_loop(d, factory, device="cuda")
        data = apps.wav_bytes(loop3, sr3)
        walls["apps callback + wav_bytes"] = time.perf_counter() - t0
        with wave.open(io.BytesIO(data)) as w:
            if (w.getframerate(), w.getnframes(), w.getnchannels()) != (sr, len(loop3), 1):
                fail(f"[apps] wav_bytes: {w.getframerate()} Hz, {w.getnframes()} frames, {w.getnchannels()} channels")
        check_audio("apps callback", audio3, gen_len)
        if len(app_counted.calls) != 1 or image3.size != (256, 256) or len(loop3) == 0:
            fail(f"[apps] the callback made {len(app_counted.calls)} calls, image {image3.size}")
        apps._cache.clear()

    launches = {c.__name__: c.launches for c in counters}
    calls = counted.calls[1:] + app_counted.calls
    steps = sum(c["steps"] for c in calls)
    runs = sum(c["steps"] * c["runs"] for c in calls)  # a capture's eager warm-up runs its steps once more
    if launches != {"group_norm_silu": 64 * runs, "flash_mha": 6 * runs}:
        fail(f"[apps] launches {launches} over {steps} denoise steps ({runs} with the captures' warm-ups)")
    print(f"[apps] saved + loaded through AudioDiffusion(dtype=bfloat16, fused_groupnorm=True) in {t_load:.2f} s, "
          f"apps.get_model {t_app_load:.2f} s; walls: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in walls.items())
          + f"; loop_it of the generated clip: {'none' if generated_loop is None else len(generated_loop)} samples  "
          f"[{card}]")
    print(f"[apps] ok: {len(calls)} pipeline calls, {steps} denoise steps, launches {launches} = 64 and 6 per denoise "
          f"step of every call, and of the eager warm-up of each of the "
          f"{sum(c['runs'] - 1 for c in calls)} captures; lengths by the stitch "
          f"arithmetic; serial remix pinned (first window bitwise a direct "
          f"call), parallel remix one call of {APPS_REMIX_WINDOWS} rows")
    return launches


def phase_prepare(card: str):
    """Dataset preparation on the card: four synthetic WAVs through
    ``find_audio_files`` -> ``file_to_examples`` on the card and on the CPU,
    and ``AudioEncoder.encode`` of the files on the card against its CPU forward."""
    import io
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from audio_diffusion_torch.data import prepare
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AudioEncoder
    from audio_diffusion_torch.ops import audio_io

    mels = {dev: Mel(x_res=256, y_res=256, hop_length=512, device=dev) for dev in ("cuda", "cpu")}
    n = mels["cuda"].slice_size
    with tempfile.TemporaryDirectory() as d:
        audio_io.write_wav(f"{d}/a_mono22k.wav", synth_audio(int(2.3 * n), seed=0), 22050)
        audio_io.write_wav(f"{d}/b_stereo44k.wav",
                           np.stack([synth_audio(int(4.4 * n), 44100, seed=s) for s in (1, 2)]), 44100)
        audio_io.write_wav(f"{d}/c_silence.wav",
                           np.concatenate([synth_audio(n, seed=3), np.zeros(int(1.5 * n), np.float32)]), 22050)
        audio_io.write_wav(f"{d}/d_short.wav", synth_audio(int(0.4 * n), seed=4), 22050)
        files = prepare.find_audio_files(d)
        prepare.file_to_examples(mels["cuda"], files[0])  # warm-up
        kept, worst, times = {}, (0, 0.0), {"cuda": [], "cpu": []}
        for f in files:
            examples = {}
            for dev, mel in mels.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                examples[dev] = prepare.file_to_examples(mel, f)
                times[dev].append(time.perf_counter() - t0)
            slices = [[e["slice"] for e in examples[dev]] for dev in ("cuda", "cpu")]
            if slices[0] != slices[1]:
                fail(f"[prepare] {f}: slices kept on the card {slices[0]}, on the CPU {slices[1]}")
            kept[Path(f).name] = slices[0]
            for a, b in zip(examples["cuda"], examples["cpu"]):
                ia, ib = (np.asarray(Image.open(io.BytesIO(e["image"]["bytes"]))).astype(int) for e in (a, b))
                diff = np.abs(ia - ib)
                worst = max(worst, (int(diff.max()), float(diff.mean())))
                if ia.shape != (256, 256) or diff.max() > 1 or diff.mean() >= 0.02:
                    fail(f"[prepare] {f} slice {a['slice']}: card vs CPU image max {diff.max()}, "
                         f"mean {diff.mean()}")
        mel = mels["cuda"]
        mel.load_audio(files[0])
        direct = mel.spectrogram_images_from_audio(np.stack([mel.get_audio_slice(i) for i in range(2)])).cpu().numpy()
        png = np.asarray(Image.open(io.BytesIO(prepare.file_to_examples(mel, files[0])[1]["image"]["bytes"])))
        if not np.array_equal(png, direct[1]):
            fail("[prepare] a PNG does not decode to the Mel's image")
        want = {"a_mono22k.wav": [0, 1], "b_stereo44k.wav": [0, 1], "c_silence.wav": [0], "d_short.wav": [0]}
        if kept != want:
            fail(f"[prepare] slices kept {kept}, expected {want} (the silent slice of c skipped)")

        enc = AudioEncoder().init_params(torch.Generator().manual_seed(15)).eval()
        dev = AudioEncoder().eval()
        dev.load_state_dict(enc.state_dict())
        dev = dev.to("cuda")
        dev.encode(files)  # warm-up
        images = []
        hook = dev.register_forward_pre_hook(lambda mod, args: images.append(args[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_slice = dev.encode(files, pool=None)
        torch.cuda.synchronize()
        enc_wall = time.perf_counter() - t0
        hook.remove()
        pooled = dev.encode(files)
        with torch.inference_mode():
            ref = enc(images[0].cpu())
        got = torch.cat(per_slice).cpu()
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())  # as [cond]: sum order over a 41,472-long dot, TF32 off
        means = torch.stack([s.mean(0) for s in per_slice])
        if not (got.shape == ref.shape and err <= tol and torch.allclose(pooled, means, rtol=0, atol=1e-6)):
            fail(f"[prepare] AudioEncoder.encode on the card vs its CPU forward: max abs err {err} > {tol}")
    decoders = sorted({audio_io.decoder_for(f) for f in files})
    print(f"[prepare] {len(files)} WAVs (22.05 kHz mono, 44.1 kHz stereo, a silent slice, shorter than a slice), "
          f"decoder {decoders}: slices kept {kept}; card vs CPU images max/mean diff {worst[0]}/{worst[1]:.5f}; "
          f"file_to_examples s per file, card {[round(t, 4) for t in times['cuda']]}, CPU "
          f"{[round(t, 4) for t in times['cpu']]}  [{card}]")
    print(f"[prepare] ok: AudioEncoder.encode of the {len(files)} files ({got.shape[0]} slices) on the card in "
          f"{enc_wall:.4f} s, against its CPU forward max abs err {err:.3g} (tol {tol:.3g})  [{card}]")


def phase_golden(card: str):
    """The port's Mel on the card against tests/goldens/mel_goldens.npz at the
    limits of tests/test_mel.py: the forward image (max |diff| <= 1, mean <
    0.02) and the Griffin-Lim round-trip MAE (below the frozen value + 1.1)."""
    import numpy as np
    import torch

    from audio_diffusion_torch.mel import Mel

    goldens = np.load(REPO / "tests" / "goldens" / "mel_goldens.npz")
    rows = []
    for res, hop, seed in ((256, 512, 0), (64, 1024, 4)):
        mel = Mel(x_res=res, y_res=res, hop_length=hop, device="cuda")
        img = mel.spectrogram_images_from_audio(synth_audio(mel.slice_size, seed=seed)[None])
        diff = np.abs(img[0].cpu().numpy().astype(int) - goldens[f"image_{res}"].astype(int))
        rec = mel.images_to_audio(img)[0]
        img2 = mel.spectrogram_images_from_audio(torch.nn.functional.pad(rec, (0, mel.slice_size - rec.shape[0]))[None])
        mae = (img.float() - img2.float()).abs().mean().item()
        bound = float(goldens[f"roundtrip_mae_{res}"]) + 1.1
        if diff.max() > 1 or diff.mean() >= 0.02 or not mae < bound:
            fail(f"[golden] {res}x{res}: image max {diff.max()} mean {diff.mean()}, round-trip MAE {mae} (< {bound})")
        rows.append(f"{res}x{res} hop {hop}: image max/mean diff {diff.max()}/{diff.mean():.5f}, round-trip MAE "
                    f"{mae:.4f} (< {bound:.4f})")
    print(f"[golden] ok: " + "; ".join(rows) + f"  [{card}]")


# ------------------------------------------------------------------ the dp group

def _dp_unet_numel() -> int:
    """The latent-256 UNet's parameter count (113.67 M), from a model on the meta device."""
    import torch

    from audio_diffusion_torch.models import UNet2D, unconditional_config

    with torch.device("meta"):
        return sum(p.numel() for p in UNet2D(unconditional_config((32, 32), 4, 4)).parameters())


def dp_rank(rank: int, world: int, init: str, device: str, backend: str, shardings: list, root: Path,
            tag: str) -> None:
    """One rank of [dp] (this script re-run with --dp-rank): joins the group and, for each
    sharding, trains the [train] setup DP_STEPS steps through run_training and resumes to
    DP_RESUME_TO; then times an all-reduce of the gradient's bytes and profiles 2 steps.
    Writes what it saw to ``root/<tag>_<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from audio_diffusion_torch.models import UNet2D, unconditional_config
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.parallel import init_distributed
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training import RunConfig, TrainConfig, run_training
    from audio_diffusion_torch.training.train_unet import init_train_state, make_train_step, wrap_unet

    init_distributed(init, world, rank, device=device, backend=backend, timeout_s=DP_RANK_TIMEOUT_S)
    out = {"rank": rank, "world": world, "backend": backend, "device": device, "configs": {}}
    try:
        for sharding in shardings:
            train = TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0, gradient_accumulation_steps=TRAIN_ACCUM,
                                param_sharding=sharding)
            at.flash_mha.launches = at.FlashMHA.backwards = gn.group_norm_silu.launches = 0
            results = [run_training(RunConfig(
                dataset=str(root / "slices"), output_dir=str(root / f"model_{tag}_{sharding}"),
                train_batch_size=TRAIN_MICRO, vae=str(root / "vae"), mixed_precision="bf16", max_steps=max_steps,
                save_images_epochs=1000, log_every=1, device=device, timing=True), train)
                for max_steps in (DP_STEPS, DP_RESUME_TO)]
            torch.cuda.synchronize()
            launches = {"flash_mha": at.flash_mha.launches, "FlashMHA.backward": at.FlashMHA.backwards,
                        "group_norm_silu": gn.group_norm_silu.launches}
            tm = {k: results[0]["timings"][k][1:] + results[1]["timings"][k][1:] for k in results[0]["timings"]}

            # 2 steps under the profiler (after 2 warm-up steps): this rank's device busy share
            unet = UNet2D(unconditional_config((32, 32), dtype="bfloat16")).to(device).train()
            model = wrap_unet(train, unet)
            state = init_train_state(train, model)
            step = make_train_step(train, model, DDPMScheduler(), cached_latents=True)
            g = torch.Generator(device=device).manual_seed(3 + rank)
            rows = TRAIN_MICRO // world
            moments = torch.cat([torch.randn((TRAIN_ACCUM, rows, 32, 32, 1), generator=g, device=device),
                                 torch.full((TRAIN_ACCUM, rows, 32, 32, 1), -2.0, device=device)], dim=-1)
            for _ in range(2):
                step(state, moments)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    step(state, moments)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
            del model, unet, state, step
            out["configs"][sharding] = {
                "losses": results[0]["losses"] + results[1]["losses"],
                "steps": [r["steps"] for r in results], "saves": sum(r["saves"] for r in results),
                "launches": launches, "peak_gib": step_peak_gib(results),
                "step_ms": float(np.mean(tm["step_ms"])), "fwd_bwd_ms": float(np.mean(tm["fwd_bwd_ms"])),
                "optimizer_ema_ms": float(np.mean(tm["optimizer_ema_ms"])), "idle_pct": 100 - 100 * busy / wall_us}
            torch.cuda.empty_cache()

        # DDP's collective on this group: one all-reduce of the gradient's f32 bytes, host wall
        buf = torch.zeros(_dp_unet_numel(), device=device)
        for _ in range(2):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        out["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        out["allreduce_mib"] = buf.numel() * 4 / 2**20
    finally:
        dist.destroy_process_group()
    out["ended"] = time.time()
    (root / f"{tag}_{rank}.json").write_text(json.dumps(out))


def _dp_run(tag: str, shardings) -> str:
    """The name of one [dp] group's files and output: its tag and shardings."""
    return f"{tag}-{'+'.join(shardings)}"


@contextlib.contextmanager
def dp_processes(card: str, root: Path):
    """[dp] started (module docstring, phase 14): the data and the VAE
    written, then every group of ranks as processes of their own
    (``dp_rank``), side by side with each other and with what this process
    runs meanwhile, and here the one-process run of step 1 that the ranks
    take first. Yields what dp_finish reads; kills any rank left at the exit."""
    import shutil

    import torch

    from audio_diffusion_torch.training import RunConfig, TrainConfig, run_training

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    write_training_data(root)
    save_training_vae(root)
    if n >= 2:
        w = min(n, DP_MAX_RANKS)
        plan = [("nccl", w, "nccl", [f"cuda:{i}" for i in range(w)], ("replicated", "fsdp"))]
    else:  # NCCL refuses two ranks on one card; gloo carries DDP's all-reduce, not FSDP's collectives
        # (NCCL's DDP and FSDP in one process: a fourth process beside [rebuild]'s brought the card within
        # 0.7 GiB of its memory)
        plan = [("gloo", 2, "gloo", ["cuda:0", "cuda:0"], ("replicated",)),
                ("nccl1", 1, "nccl", ["cuda:0"], ("replicated", "fsdp"))]
    groups = {}
    try:
        started = time.time()
        for tag, world, backend, devices, shardings in plan:
            run = _dp_run(tag, shardings)
            logs = [open(root / f"{run}_{rank}.log", "w") for rank in range(world)]
            groups[run] = logs, [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dp-rank", str(rank), "--dp-world", str(world),
                 "--dp-init", f"file://{root / f'rendezvous_{run}'}", "--dp-device", devices[rank], "--dp-backend",
                 backend, "--dp-shardings", ",".join(shardings), "--dp-root", str(root), "--dp-tag", run],
                stdout=log, stderr=subprocess.STDOUT) for rank, log in enumerate(logs)]
        ref = run_training(RunConfig(dataset=str(root / "slices"), output_dir=str(root / "model_ref"),
                                     train_batch_size=TRAIN_MICRO, vae=str(root / "vae"), mixed_precision="bf16",
                                     max_steps=1, save_images_epochs=1000, device="cuda"),
                           TrainConfig(learning_rate=TRAIN_LR, lr_warmup_steps=0,
                                       gradient_accumulation_steps=TRAIN_ACCUM))
        shutil.rmtree(root / "model_ref")
        print(f"[dp] data, VAE and the one-process step 1 (loss {ref['losses'][0]:.6f}) in "
              f"{time.perf_counter() - t0:.2f} s; {n} card(s); {len(plan)} group(s) of ranks started")
        yield {"root": root, "plan": plan, "groups": groups, "started": started, "ref_loss": ref["losses"][0]}
    finally:
        for logs, procs in groups.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()


def dp_finish(run: dict, card: str) -> dict:
    """Waits for [dp]'s ranks and holds what each wrote to the checks of
    phase 14. Returns each rank's kernel launches."""
    import shutil

    import numpy as np

    root, plan, groups, ref_loss = run["root"], run["plan"], run["groups"], run["ref_loss"]
    while True:  # a rank that fails ends the phase: its peers would wait
        failed = [(name, rank, p.returncode) for name, (_, procs) in groups.items() for rank, p in enumerate(procs)
                  if p.poll() not in (None, 0)]
        if failed or all(p.poll() is not None for _, procs in groups.values() for p in procs):
            break
        if time.time() - run["started"] > DP_RANK_TIMEOUT_S:
            fail(f"[dp] a rank did not finish within {DP_RANK_TIMEOUT_S} s")
        time.sleep(0.1)
    for name, rank, code in failed[:1]:
        print((root / f"{name}_{rank}.log").read_text()[-6000:], file=sys.stderr)
        fail(f"[dp] {name}: rank {rank} exited {code}")
    launches, peaks = {}, {}
    want = {"flash_mha": TRAIN_ATTN * TRAIN_ACCUM * DP_RESUME_TO,
            "FlashMHA.backward": TRAIN_ATTN * TRAIN_ACCUM * DP_RESUME_TO, "group_norm_silu": 0}
    if len(plan) > 1:
        print(f"[dp] the groups {[_dp_run(t, s) for t, _, _, _, s in plan]} ran side by side on the card, beside "
              f"[shard], [encoder-train], [cond-train] and [rebuild]'s processes: their times include each "
              f"other's load")
    for tag, world, backend, devices, shardings in plan:
        name = _dp_run(tag, shardings)
        reports = [json.loads((root / f"{name}_{rank}.json").read_text()) for rank in range(world)]
        wall = max(r["ended"] for r in reports) - run["started"]
        print(f"[dp] {tag}: backend {backend}, world {world}, devices {devices}; {wall:.2f} s for "
              f"{'+'.join(shardings)}; all-reduce of the gradient ({reports[0]['allreduce_mib']:.1f} MiB f32, "
              f"host wall) {reports[0]['allreduce_ms']:.4f} ms  [{card}]")
        for sharding in shardings:
            runs = [r["configs"][sharding] for r in reports]
            first = runs[0]
            if any(r["losses"] != first["losses"] for r in runs):
                fail(f"[dp] {tag}/{sharding}: the ranks' losses differ: {[r['losses'] for r in runs]}")
            if first["steps"] != [DP_STEPS, DP_RESUME_TO] or len(first["losses"]) != DP_RESUME_TO:
                fail(f"[dp] {tag}/{sharding}: steps {first['steps']}, {len(first['losses'])} losses")
            if not np.isfinite(first["losses"]).all():
                fail(f"[dp] {tag}/{sharding}: non-finite losses {first['losses']}")
            if not (runs[0]["saves"] == 2 and all(r["saves"] == 0 for r in runs[1:])):
                fail(f"[dp] {tag}/{sharding}: saves per rank {[r['saves'] for r in runs]} (rank 0 alone writes)")
            rel = abs(first["losses"][0] - ref_loss) / abs(ref_loss)
            if not rel <= 1e-3:
                fail(f"[dp] {tag}/{sharding}: step 1 loss {first['losses'][0]} vs one process {ref_loss} "
                     f"(rel {rel:.3g} > 1e-3)")
            for rank, r in enumerate(runs):
                if r["launches"] != want:
                    fail(f"[dp] {tag}/{sharding} rank {rank}: launches {r['launches']}, expected {want}")
                launches[f"{tag}/{sharding}/rank{rank}"] = r["launches"]
            peaks[f"{tag}/{sharding}"] = [r["peak_gib"] for r in runs]
            samples = TRAIN_MICRO * TRAIN_ACCUM
            print(f"[dp] {tag}/{sharding} ok: {DP_STEPS} steps + resumed to {DP_RESUME_TO}, losses "
                  f"{np.round(first['losses'], 4).tolist()} bitwise the same on all {world} rank(s); step 1 within "
                  f"{rel:.3g} of one process; saves per rank {[r['saves'] for r in runs]}; per rank "
                  f"{want['flash_mha']} flash_mha and FlashMHA.backward launches, 0 GroupNorm; rank 0: "
                  f"{first['step_ms']:.4f} ms/step = {1e3 / first['step_ms']:.4f} steps/s = "
                  f"{1e3 / first['step_ms'] * samples:.4f} samples/s (global micro {TRAIN_MICRO} x accum "
                  f"{TRAIN_ACCUM}), forward+backward {first['fwd_bwd_ms']:.4f} ms, optimizer+EMA "
                  f"{first['optimizer_ema_ms']:.4f} ms (CUDA events); peak allocated in a step per rank "
                  f"{[round(r['peak_gib'], 4) for r in runs]} GiB; device idle per rank (2 profiled steps) "
                  f"{[round(r['idle_pct'], 2) for r in runs]}%  [{card}]")
            shutil.rmtree(root / f"model_{name}_{sharding}", ignore_errors=True)
    fsdp = {k: v for k, v in peaks.items() if k.endswith("/fsdp")}
    print("[dp] peak allocated in a step per rank, FSDP beside DDP: "
          + "; ".join(f"{k} {[round(x, 4) for x in v]} GiB" for k, v in peaks.items())
          + f" (FSDP runs: {sorted(fsdp)})  [{card}]")
    return launches


def phase_shard(card: str) -> dict:
    """The [main] pipeline sharded over the cards (over [cuda:0, cuda:0] on one
    card): a batch of SHARD_BATCH at STEPS steps bitwise the unsharded call with
    cuDNN off, the difference with cuDNN on, and make_server over the mesh.
    Returns the kernels' launches on the sharded path."""
    import tempfile

    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.parallel import make_mesh
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.serving import make_server

    n = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(min(n, DP_MAX_RANKS))] if n >= 2 else ["cuda:0", "cuda:0"]
    pipe = build_pipeline()
    sharded = AudioDiffusionPipeline(pipe.unet, pipe.mel, pipe.scheduler, pipe.vqvae, device="cuda").shard(
        make_mesh(devices=devices))
    data = len(devices)

    def call(p, cudnn):
        torch.backends.cudnn.enabled = cudnn
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(61)
            raw, audio = p(batch_size=SHARD_BATCH, steps=STEPS, generator=gen, return_arrays=True)
            for d in {*devices, "cuda:0"}:
                torch.cuda.synchronize(d)
            return raw, audio, time.perf_counter() - t0
        finally:
            torch.backends.cudnn.enabled = True

    counters = (gn.group_norm_silu, at.flash_mha)
    for p in (pipe, sharded):  # warm-up: each captures one program per cuDNN setting
        call(p, False), call(p, True)
    ref_off, ref_on = call(pipe, False), call(pipe, True)  # the unsharded calls: the comparison, not counted
    for c in counters:
        c.launches = 0
    off, on = call(sharded, False), call(sharded, True)
    per_call = [c.launches // 2 for c in counters]
    want = [64 * STEPS * data, 6 * STEPS * data]
    if [c.launches for c in counters] != [2 * w for w in want]:
        fail(f"[shard] launches (group_norm_silu, flash_mha) {[c.launches for c in counters]} over 2 calls, "
             f"expected {[2 * w for w in want]}")
    def audio_diff(a, b):  # relative to the peak: Griffin-Lim runs batch-shaped matmuls and FFTs
        return ((a[1] - b[1]).abs().max() / b[1].abs().max()).item()

    if not torch.equal(off[0], ref_off[0]):
        fail(f"[shard] with cuDNN off the sharded spectrograms are not bitwise the unsharded ones: uint8 max diff "
             f"{(off[0].int() - ref_off[0].int()).abs().max().item()}")
    if not audio_diff(off, ref_off) <= SHARD_AUDIO_BOUND:
        fail(f"[shard] audio from the same spectrograms and phase differs by {audio_diff(off, ref_off)} of its peak")
    on_diff = (on[0].int() - ref_on[0].int()).abs().max().item()
    print(f"[shard] ok: batch {SHARD_BATCH} x {STEPS} steps over {data} replicas on {devices}: with cuDNN off the "
          f"spectrograms bitwise the unsharded call's, audio max diff {audio_diff(off, ref_off):.3g} of its peak "
          f"(bound {SHARD_AUDIO_BOUND:g}), wall {off[2]:.4f} s sharded vs {ref_off[2]:.4f} s unsharded; with cuDNN "
          f"on max uint8 diff {on_diff}, audio {audio_diff(on, ref_on):.3g}, wall {on[2]:.4f} s vs {ref_on[2]:.4f} s; "
          f"launches per call (group_norm_silu, flash_mha) {per_call}  [{card}]")

    with tempfile.TemporaryDirectory() as d:
        pipe.save_pretrained(d)
        mesh_kw = dict(mesh_data=data) if n >= 2 else dict(mesh_devices=devices)
        server = make_server(d, dtype="bfloat16", fused_groupnorm=True, device="cuda", port=0, max_batch=SHARD_BATCH,
                             max_wait_ms=500, steps=STEPS, **mesh_kw)
        tiers = server.batcher.tiers
        if not all(t % data == 0 for t in tiers):
            fail(f"[shard] tiers {tiers} are not multiples of the data-axis size {data}")
        server.start()
        try:
            bodies = [{"seed": 400 + i} for i in range(SHARD_BATCH)]
            t0 = time.perf_counter()
            responses = _concurrently(*server.address[:2], bodies)
            wall = time.perf_counter() - t0
            _check_wavs(bodies, responses, server.batcher.pipe.mel, "[shard]")
            batches = [(s["n"], s["tier"]) for s in server.batcher.stats]
        finally:
            server.stop()
    launches = {c.__name__: c.launches for c in counters}
    if not all(v > 0 for v in launches.values()):
        fail(f"[shard] the kernels were not launched on the sharded path: {launches}")
    print(f"[shard] make_server({mesh_kw}) tiers {tiers}: {SHARD_BATCH} concurrent requests answered 200 with full "
          f"wavs in {wall:.4f} s (batches (n, tier) {batches}); launches on the sharded path {launches}  [{card}]")
    del sharded, pipe
    torch.cuda.empty_cache()
    return launches


def phase_encoder_train(card: str) -> None:
    """The full-width AudioEncoder in train mode on the card: batch
    ENCODER_TRAIN_BATCH forward (batch statistics, dropout from a generator)
    and backward; the running statistics move; ``encode`` is untouched by ``.train()``."""
    import torch

    from audio_diffusion_torch.models import AudioEncoder

    enc = AudioEncoder().init_params(torch.Generator().manual_seed(12)).to("cuda")
    clips = encoder_clips(2, 15)
    enc.eval()
    before = enc.encode(clips)
    enc.train()
    after = enc.encode(clips)
    if not torch.equal(before, after):
        fail("[encoder-train] encode changed with .train()")
    norms = [m for m in enc.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    stats = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    x = torch.rand((ENCODER_TRAIN_BATCH, 1, 96, 216), generator=torch.Generator(device="cuda").manual_seed(4),
                   device="cuda")
    walls = []
    for i in range(3):
        enc.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = enc(x, train=True, generator=torch.Generator(device="cuda").manual_seed(5 + i))
        out.square().mean().backward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    grads = [p.grad for p in enc.parameters()]
    if tuple(out.shape) != (ENCODER_TRAIN_BATCH, 100) or not torch.isfinite(out).all() or any(
            g is None or not torch.isfinite(g).all() for g in grads):
        fail(f"[encoder-train] output {tuple(out.shape)}, finite output/gradients failed")
    moved = [not (torch.equal(m.running_mean, a) or torch.equal(m.running_var, b)) for m, (a, b) in zip(norms, stats)]
    if not all(moved):
        fail(f"[encoder-train] running statistics moved per BatchNorm: {moved}")
    print(f"[encoder-train] ok: AudioEncoder (full width, 41,472 -> 1,024 dense) train=True batch "
          f"{ENCODER_TRAIN_BATCH}: forward+backward wall {walls[1] * 1e3:.4f} / {walls[2] * 1e3:.4f} ms (after a "
          f"warm-up of {walls[0] * 1e3:.4f} ms); all {len(norms)} BatchNorms' running statistics moved; encode "
          f"bitwise the same before and after .train()  [{card}]")
    del enc
    torch.cuda.empty_cache()


def _dir_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def phase_native(pipe, card: str, root: Path) -> dict:
    """The [main] pipeline saved in the diffusers layout, in the JAX package's
    native layout (params.msgpack) and as the diffusers layout with
    ``.safetensors`` weights (written by the port's writer); each reloaded
    through ``from_pretrained(dtype="bfloat16", fused_groupnorm=True)`` answers
    a batch-8 request at 50 steps bitwise the original's, through both kernels
    (64 GroupNorm+SiLU and 6 attention launches per denoise step). Each
    reloaded pipeline's first call captures its program; the counts are set
    to 0 before the request that follows, a replay, and read after it."""
    import shutil

    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline
    from audio_diffusion_torch.utils import diffusers_io, safetensors_io

    counters = (gn.group_norm_silu, at.flash_mha)

    def request(p):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, audio = p(batch_size=NATIVE_BATCH, steps=STEPS,
                       generator=torch.Generator(device="cuda").manual_seed(NATIVE_SEED), return_arrays=True)
        torch.cuda.synchronize()
        return raw, audio, time.perf_counter() - t0, [c.launches for c in counters]

    want_raw, want_audio, want_wall, _ = request(pipe)
    saves = {}
    for layout in ("diffusers", "native"):
        t0 = time.perf_counter()
        pipe.save_pretrained(str(root / layout), layout=layout)
        saves[layout] = time.perf_counter() - t0
    st = root / "safetensors"
    shutil.copytree(root / "diffusers", st)
    t0 = time.perf_counter()
    for sub, module in (("unet", pipe.unet), ("vqvae", pipe.vqvae)):
        (st / sub / diffusers_io.WEIGHTS_NAME).unlink()
        safetensors_io.save_file({k: v.numpy() for k, v in diffusers_io.cpu_state_dict(module).items()},
                                 str(st / sub / diffusers_io.SAFETENSORS_NAME))
    saves["safetensors"] = time.perf_counter() - t0  # the two weights files alone
    per_layout = {}
    for layout in NATIVE_LAYOUTS:
        t0 = time.perf_counter()
        loaded = AudioDiffusionPipeline.from_pretrained(str(root / layout), dtype="bfloat16", fused_groupnorm=True,
                                                        device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for a, b in ((loaded.unet, pipe.unet), (loaded.vqvae, pipe.vqvae)):
            sa, sb = a.state_dict(), b.state_dict()
            if a.config != b.config or sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
                fail(f"[native] {layout}: the reloaded {type(a).__name__} differs from the saved one")
        capture_wall = request(loaded)[2]  # the first call captures the program; the counted one replays it
        raw, audio, wall, launches = request(loaded)
        if not (torch.equal(raw, want_raw) and torch.equal(audio, want_audio)):
            fail(f"[native] {layout}: the reloaded pipeline's batch-{NATIVE_BATCH} request differs from the "
                 f"original's (max uint8 diff {(raw.int() - want_raw.int()).abs().max().item()})")
        want = [64 * STEPS, 6 * STEPS]
        if launches != want:
            fail(f"[native] {layout}: launches (group_norm_silu, flash_mha) {launches}, expected {want}")
        weights = sum(f.stat().st_size for f in (root / layout).rglob("*")
                      if f.name in (diffusers_io.WEIGHTS_NAME, diffusers_io.SAFETENSORS_NAME, diffusers_io.NATIVE_NAME))
        print(f"[native] {layout}: save {saves[layout]:.4f} s, {_dir_bytes(root / layout)} bytes ({weights} of "
              f"weights), load {load_s:.4f} s; batch-{NATIVE_BATCH} request at {STEPS} steps {wall:.4f} s, a replay "
              f"(the first call, with its capture, {capture_wall:.4f} s; the original's {want_wall:.4f} s) bitwise "
              f"the original's spectrograms and audio; launches "
              f"group_norm_silu/flash_mha {launches} = {[n // STEPS for n in launches]} per denoise step  [{card}]")
        per_layout[layout] = dict(zip(("group_norm_silu", "flash_mha"), launches))
        del loaded
        torch.cuda.empty_cache()
    print(f"[native] ok: {len(NATIVE_LAYOUTS)} layouts reloaded bitwise")
    return per_layout


def phase_cond_train(card: str, root: Path) -> dict:
    """The conditional recipe, ``scripts.cond_selectivity_evidence``, at full
    width (256x256 mels, the 256 KL-VAE to 32x32 latents, the conditional
    UNet, batch 16, bf16) with its step counts cut: the 4-class corpus, the
    AudioEncoder's class encodings, the VAE and UNet trainers, and the
    selectivity evaluation (4 classes x batch 8 x 50 steps through
    ``encoding=`` with the GroupNorm+SiLU kernel). The UNet's loss must fall;
    the GroupNorm+SiLU kernel runs only in the evaluation (training runs
    torch's GroupNorm: the kernel has no backward), and the recipe's UNet has
    no SelfAttention2D, so no attention-kernel launch."""
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.scripts import cond_selectivity_evidence as recipe

    counters = {"group_norm_silu": gn.group_norm_silu, "flash_mha": at.flash_mha}
    for c in counters.values():
        c.launches = 0
    at.FlashMHA.backwards = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = recipe.main(["--work", str(root / "cond_ev"), "--vae_steps", str(COND_TRAIN_VAE_STEPS),
                          "--unet_steps", str(COND_TRAIN_UNET_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: c.launches for name, c in counters.items()}
    launches["FlashMHA.backward"] = at.FlashMHA.backwards
    vae, unet = result["vae"], result["unet"]
    # the evaluation's calls (return_images_only: the staged path) share one signature, and the first one's
    # capture warms the denoise stage up eagerly: its steps run once more
    want = {"group_norm_silu": COND_NORMS * STEPS * (COND_TRAIN_CLASSES + 1), "flash_mha": 0, "FlashMHA.backward": 0}
    if launches != want:
        fail(f"[cond-train] launches {launches}, expected {want}")
    if vae["steps"] != COND_TRAIN_VAE_STEPS or unet["steps"] != COND_TRAIN_UNET_STEPS:
        fail(f"[cond-train] trained {vae['steps']} VAE and {unet['steps']} UNet steps")
    if not unet["loss_last_mean"] < unet["loss_first_mean"]:
        fail(f"[cond-train] the UNet's loss did not fall: {unet}")
    nn = [v for r in result["per_class"].values() for v in (r["own_nn_mae"], r["best_other_nn_mae"])]
    if len(result["per_class"]) != COND_TRAIN_CLASSES or not all(0 < v < 255 for v in nn):
        fail(f"[cond-train] selectivity report {result['per_class']}")
    print(f"[cond-train] recipe at full width (the recipe's 1,200 VAE and 6,000 UNet steps cut to "
          f"{COND_TRAIN_VAE_STEPS} and {COND_TRAIN_UNET_STEPS}): {result['files']} files; VAE {vae['steps']} steps in "
          f"{vae['seconds']:.4f} s = {vae['steps'] / vae['seconds']:.4f} steps/s (batch 2, a save every epoch of 12 "
          f"steps included), logged losses {vae['logged_losses']}; UNet {unet['steps']} steps in "
          f"{unet['seconds']:.4f} s = {unet['steps'] / unet['seconds']:.4f} steps/s (batch 16, bf16, latent caching "
          f"and the final save included), loss {unet['loss_first']:.4f} -> {unet['loss_last']:.4f}, mean of the "
          f"first / last {unet['loss_window']} steps {unet['loss_first_mean']:.4f} -> {unet['loss_last_mean']:.4f}; "
          f"peak {peak:.4f} GiB; whole recipe {wall:.4f} s  [{card}]")
    print(f"[cond-train] selectivity ({COND_TRAIN_CLASSES} classes x batch {COND_TRAIN_EVAL_BATCH} x {STEPS} steps, "
          f"own-class vs best other-class nearest-neighbour MAE, uint8): {result['selective_classes']} selective; "
          + "; ".join(f"{c} {r['own_nn_mae']} vs {r['best_other_nn_mae']}" for c, r in result["per_class"].items())
          + f"; launches {launches} (GroupNorm+SiLU {COND_NORMS} per UNet forward of the evaluation; the "
          f"recipe's UNet has no SelfAttention2D)  [{card}]")
    return launches


@contextlib.contextmanager
def plain_versions():
    """The UNet's GroupNorm+SiLU and self-attention through their plain
    PyTorch versions on the card (the wrappers would launch the kernels)."""
    from audio_diffusion_torch.models import unet2d
    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn

    kernels = unet2d.fused_group_norm_silu, unet2d.multi_head_attention
    unet2d.fused_group_norm_silu, unet2d.multi_head_attention = gn.group_norm_silu_plain, at.attention_plain
    try:
        yield
    finally:
        unet2d.fused_group_norm_silu, unet2d.multi_head_attention = kernels


@contextlib.contextmanager
def unimportable(*modules: str):
    """``import`` of each of ``modules`` raises ImportError inside the block,
    imported before or not."""
    kept = {m: sys.modules.get(m) for m in modules}
    sys.modules.update(dict.fromkeys(modules))
    try:
        yield
    finally:
        for m, mod in kept.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def trained_against_plain(out: str, name: str, encoding) -> dict:
    """One batch-2 request of the trained pipeline in its saved precision (f32),
    op by op, with the kernels against the same request through the plain
    versions, which launch nothing: uint8 within 1."""
    import numpy as np
    import torch

    from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline
    from audio_diffusion_torch.scripts.rebuild import launch_counts

    pipe = AudioDiffusionPipeline.from_pretrained(out, fused_groupnorm=True, device="cuda")
    batch, seed = REBUILD_PLAIN

    def call():
        with pipe._uncaptured():
            return pipe(batch_size=batch, steps=REBUILD_STEPS, encoding=encoding, return_images_only=True,
                        generator=torch.Generator(device="cuda").manual_seed(seed))

    before = launch_counts()
    kernels = call()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    before = launch_counts()
    with plain_versions():
        plain = call()
    if launch_counts() != before:
        fail(f"[rebuild] {name}: the plain versions launched a kernel")
    want = {"group_norm_silu": REBUILD_STEPS * REBUILD_NORMS[name], "flash_mha": REBUILD_STEPS * REBUILD_ATTN[name],
            "FlashMHA.backward": 0}
    if launched != want:
        fail(f"[rebuild] {name}: the trained request launched {launched}, expected {want}")
    diff = int(np.abs(kernels.astype(np.int32) - plain.astype(np.int32)).max())
    if kernels.shape != plain.shape or diff > 1:
        fail(f"[rebuild] {name}: the trained request with the kernels is {diff} uint8 from the plain versions")
    del pipe
    torch.cuda.empty_cache()
    return {"max_uint8_diff": diff, "differing_share": float((kernels != plain).mean()), "launches": launched,
            "std": float(kernels.std())}


def train_again(recipe, r: dict, argv: list, out: Path) -> float:
    """The recipe's VAE and UNet stages trained a second time, over the
    corpus, dataset and encodings of its run ``r``, into ``out`` (the VAE into
    ``out``-vae); fails unless every tensor of both saved modules is bitwise
    the first run's and the fidelity record is the same. Returns its seconds."""
    import io

    import torch

    from audio_diffusion_torch.scripts import rebuild
    from audio_diffusion_torch.training.__main__ import main as unet_main
    from audio_diffusion_torch.training.train_vae import main as vae_main

    t0 = time.perf_counter()
    a = rebuild.parse_args(recipe, ["--output", str(out), "--work", r["work"], *argv])
    _, ds_dir, enc_path, _ = rebuild.work_paths(a.work)
    vae_dir = str(out) + "-vae"
    with contextlib.redirect_stdout(io.StringIO()), unimportable("datasets", "pandas"):
        vae_main(rebuild.vae_argv(recipe, a, ds_dir, vae_dir))
        unet_main(rebuild.unet_argv(recipe, a, ds_dir, vae_dir, enc_path, a.output))
        record, _ = rebuild.record_of(recipe, a, a.output, ds_dir, enc_path, a.device)
    differ = rebuild.differing_tensors(r["output"], a.output)
    if differ:
        fail(f"[rebuild] {recipe.name}: trained a second time, {len(differ)} saved tensors differ from the first "
             f"run's: {differ[:6]}")
    if record != r["fidelity"]:
        fail(f"[rebuild] {recipe.name}: trained a second time, the fidelity record {record} differs from the first "
             f"run's {r['fidelity']}")
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


REBUILD_RECIPES = ("latent256", "conditional_latent512")


def rebuild_recipe(recipe, card: str, root: Path) -> tuple:
    """One pinned-seed rebuild recipe (``scripts.rebuild_latent256`` or
    ``scripts.rebuild_latent512``) at full width, cut (REBUILD_CUTS), with
    ``datasets`` and ``pandas`` made unimportable: every stage runs on the
    card, the bf16 bench line passes its gates with the trained contrast
    floor, each sample of the fidelity record lies nearer the corpus than
    REBUILD_NN_BOUND, and each stage launches what it implies (the UNet's training 6
    ``flash_mha`` and 6 backwards per latent-256 step and no GroupNorm
    kernel; each bench request and each sampling step 64 / 44 GroupNorm+SiLU
    and 6 / 0 attention launches per forward, f32 attention once per block of
    8 rows; the record's first call warms its denoise stage up, so its steps
    run twice). Then a batch-2 trained request of the artifact against the
    plain versions, and its VAE and UNet trained a second time (train_again).
    Returns (every launch count by stage, the second training's seconds)."""
    import io

    import numpy as np

    from audio_diffusion_torch.data.dataset import load_encodings
    from audio_diffusion_torch.models import unet2d
    from audio_diffusion_torch.scripts import rebuild

    name = recipe.name
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), unimportable("datasets", "pandas"):
        r = rebuild.main(recipe, ["--output", str(root / name), *REBUILD_CORPUS, *REBUILD_CUTS[name],
                                  *REBUILD_BENCH])
    wall = time.perf_counter() - t0
    if json.loads(buf.getvalue().strip().splitlines()[-1]) != json.loads(json.dumps(r)):
        fail(f"[rebuild] {name}: the last line printed is not the recipe's result")
    st, lc = r["stages"], r["launches"]
    norms, attn = REBUILD_NORMS[name], REBUILD_ATTN[name]
    unet_steps = int(REBUILD_CUTS[name][REBUILD_CUTS[name].index("--unet_steps") + 1])
    want = {"corpus": (0, 0, 0), "dataset": (0, 0, 0), "encodings": (0, 0, 0), "vae": (0, 0, 0),
            "unet": (0, attn * unet_steps, attn * unet_steps),
            "fidelity": (2 * REBUILD_STEPS * norms, 2 * REBUILD_STEPS * attn, 0)}
    for stage, counts in lc.items():
        got = (counts["group_norm_silu"], counts["flash_mha"], counts["FlashMHA.backward"])
        if stage in want and got != want[stage]:
            fail(f"[rebuild] {name} {stage}: launches {got}, expected {want[stage]}")
    if not (lc["bench"]["group_norm_silu"] > 0 and (lc["bench"]["flash_mha"] > 0) == (attn > 0)):
        fail(f"[rebuild] {name} bench: launches {lc['bench']}")
    for line in r["bench"]:
        per, cfg = line["launches"]["per_request"], line["config"]
        # f32 attention blocks run on blocks of ROW_BLOCK rows on the card (models/unet2d.py::in_row_blocks)
        blocks = -(-cfg["batch"] // unet2d.ROW_BLOCK) if cfg["dtype"] == "float32" else 1
        if per != {"group_norm_silu": REBUILD_STEPS * norms, "flash_mha": REBUILD_STEPS * attn * blocks}:
            fail(f"[rebuild] {name} bench {line['config']['dtype']}: {per} launches per request")
        _on_the_card(line, f"{name} bench")
    if not (all(v < REBUILD_NN_BOUND for v in r["fidelity"]["sample_nn_mae_uint8"])
            and r["fidelity"]["sample_std_uint8"] > 5):
        fail(f"[rebuild] {name}: fidelity record {r['fidelity']} (each sample's NN MAE under "
             f"{REBUILD_NN_BOUND}, the samples' std over 5)")
    if st["unet"]["steps"] != unet_steps or not st["unet"]["loss_last_mean"] < st["unet"]["loss_first_mean"]:
        fail(f"[rebuild] {name}: the UNet's loss did not fall: {st['unet']}")
    enc = None
    if recipe.conditional:
        encs = load_encodings(str(Path(r["work"]) / "encodings.p"))
        enc = np.stack(list({v.tobytes(): v for v in encs.values()}.values())[:REBUILD_PLAIN[0]])
    plain = trained_against_plain(str(root / name), name, enc)
    again = train_again(recipe, r, [*REBUILD_CORPUS, *REBUILD_CUTS[name], *REBUILD_BENCH], root / f"{name}-again")
    timing = "; ".join(f"{k} {v['seconds']:.2f} s" + (f" ({v['steps']} steps)" if "steps" in v else "")
                       + f", peak {v['peak_allocated_gib']:.4f} GiB" for k, v in st.items())
    print(f"[rebuild] {name} at full width, cut ({' '.join(REBUILD_CORPUS + REBUILD_CUTS[name])}): {timing}; "
          f"recipe {wall:.2f} s; VAE loss {st['vae']['loss_first']:.4f} -> {st['vae']['loss_last']:.4f}, UNet "
          f"mean of the first / last {st['unet']['loss_window']} steps {st['unet']['loss_first_mean']:.4f} -> "
          f"{st['unet']['loss_last_mean']:.4f}  [{card}]")
    for line in r["bench"]:
        print(f"[rebuild] {name} bench {line['config']['dtype']} b{line['config']['batch']}: {line['value']:.4f} "
              f"{line['unit']}, gates {line['fidelity']}, launches per request {line['launches']['per_request']}")
    print(f"[rebuild] {name} fidelity record: {r['fidelity']}; the trained b{REBUILD_PLAIN[0]} f32 request with "
          f"the kernels vs the plain versions: max {plain['max_uint8_diff']} uint8 on "
          f"{plain['differing_share']:.6f} of the pixels (std {plain['std']:.4f}); launches by stage {lc}")
    print(f"[rebuild] {name} trained a second time in {again:.1f} s: every saved tensor bitwise the first run's, "
          f"the same fidelity record  [{card}]")
    return {**lc, "plain_check": plain["launches"]}, again


def rebuild_side_run(card: str, root: Path) -> dict:
    """bench's trained-weights side run over the cut latent-256 artifact in
    ``root`` (``bench.TRAINED_256_DIR`` pointed at it, so nothing lands in
    the checkout's ``models/``): every request REBUILD_STEPS steps of 64
    GroupNorm+SiLU and 6 attention launches. Returns its launches."""
    import io

    from audio_diffusion_torch import bench
    from audio_diffusion_torch.scripts import rebuild
    from audio_diffusion_torch.scripts.rebuild import launch_counts

    kept = bench.TRAINED_256_DIR
    bench.TRAINED_256_DIR = root / rebuild.LATENT_256.name
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        before = launch_counts()
        with contextlib.redirect_stdout(buf):
            line = bench.main(["--iters", "1", "--reps", "1", "--batch", "2", "--steps", str(REBUILD_STEPS)])
        side = {k: v - before[k] for k, v in launch_counts().items()}
    finally:
        bench.TRAINED_256_DIR = kept
    trained = line.get("trained")
    if trained is None:
        fail("[rebuild] bench took no trained-weights side run over the rebuilt latent-256 pipeline")
    for what, block in (("random-init", line), ("trained", trained)):
        if block["launches"]["per_request"] != {"group_norm_silu": REBUILD_STEPS * 64,
                                                "flash_mha": REBUILD_STEPS * TRAIN_ATTN}:
            fail(f"[rebuild] side run {what}: {block['launches']['per_request']} launches per request")
    print(f"[rebuild] bench side run ({time.perf_counter() - t0:.2f} s): random-init {line['value']:.4f} "
          f"{line['unit']}, trained ({trained['pipeline']}, {trained['dtype']}) {trained['value']:.4f}, gates "
          f"{trained['fidelity']}, launches per request {trained['launches']['per_request']}  [{card}]")
    return side


def side_child(name: str, root: Path) -> None:
    """One [rebuild] recipe in a process of its own (this script re-run with
    --side NAME), working in ``root/<name>``, latent256's followed by bench's
    side run. What it saw goes to ``root/<name>.json``."""
    from audio_diffusion_torch.scripts import rebuild

    card, work = card_line(), root / name
    recipe = {r.name: r for r in (rebuild.LATENT_256, rebuild.CONDITIONAL_512)}[name]
    launches, again = rebuild_recipe(recipe, card, work)
    side = rebuild_side_run(card, work) if name == rebuild.LATENT_256.name else None
    (root / f"{name}.json").write_text(json.dumps({"launches": launches, "again": again, "side_run": side,
                                                   "ended": time.time()}))


SIDE_TIMEOUT_S = 600  # each side process, from the start of the side-by-side phases


@contextlib.contextmanager
def side_processes(root: Path, names: list):
    """Each of ``names`` (REBUILD_RECIPES) started in a process of its own
    (side_child), side by side with the others and with what this process
    runs meanwhile, its standard output and error to ``root``. Yields what
    side_report reads; kills any process left at the exit. Only [rebuild]'s
    recipes run so: [native] beside them as well ran an 80 GB H100 out of
    memory (78.8 GiB in use), as every process keeps its own peak reserved."""
    procs = {}
    try:
        for name in names:
            (root / name).mkdir()
            with open(root / f"{name}.out", "w") as out, open(root / f"{name}.err", "w") as err:
                procs[name] = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--side", name,
                                                "--side-root", str(root)], stdout=out, stderr=err)
        yield {"root": root, "procs": procs, "started": time.time()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def side_report(run: dict, name: str) -> dict:
    """Waits for the side process ``name``, passes on what it printed and
    returns what it saw; fails if it failed."""
    root, p = run["root"], run["procs"][name]
    try:
        code = p.wait(timeout=max(1.0, SIDE_TIMEOUT_S - (time.time() - run["started"])))
    except subprocess.TimeoutExpired:
        fail(f"[{name}] did not finish within {SIDE_TIMEOUT_S} s of its start")
    print((root / f"{name}.out").read_text(), end="")
    err = (root / f"{name}.err").read_text()
    if code != 0:
        print(err[-6000:], file=sys.stderr)
        fail(f"[{name}]: its process exited {code}")
    print(err, end="", file=sys.stderr)
    report = json.loads((root / f"{name}.json").read_text())
    report["seconds"] = report["ended"] - run["started"]
    return report


def rebuild_finish(run: dict, card: str) -> dict:
    """Waits for [rebuild]'s processes (side_report). Returns every launch
    count by recipe and bench's side run's."""
    out, again, seconds = {}, {}, []
    for name in REBUILD_RECIPES:
        report = side_report(run, name)
        out[name], again[name] = report["launches"], report["again"]
        if report["side_run"] is not None:
            out["side_run"] = report["side_run"]
        seconds.append(report["seconds"])
    print(f"[rebuild] each recipe's VAE and UNet trained a second time: every saved tensor bitwise the first "
          f"run's, the same fidelity record  [{card}]")
    print(f"[time] [rebuild]'s second trainings took {sum(again.values()):.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in again.items()) + ")")
    print(f"[rebuild] ok in {max(seconds):.1f} s, each recipe in a process of its own, side by side with the "
          f"other phases after the train group")
    return out


PHASE_GROUPS = ("kernels", "main", "apps", "cond", "train", "dp", "interop")


MEMORY_CYCLE_BOUND = 1 << 28  # 0.25 GiB: what gc.collect() may free after a group


def release_device_memory(what: str) -> None:
    """Return the cached blocks a group of phases left behind before the next
    one measures, and print what stays reserved before and after the cycle
    collector runs. A stopped server frees its pipeline, CUDA graphs and graph
    pool, and a trainer its model and state, by reference counting; more than
    MEMORY_CYCLE_BOUND freed by the collector alone fails the run."""
    import gc
    import threading

    import torch

    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved()
    print(f"[memory] after {what}: reserved {held / 2**30:.4f} GiB, {torch.cuda.memory_reserved() / 2**30:.4f} GiB "
          f"once reference cycles are collected (allocated {torch.cuda.memory_allocated() / 2**30:.4f} GiB), "
          f"{threading.active_count()} threads")
    if freed > MEMORY_CYCLE_BOUND:
        fail(f"[memory] after {what}: {freed / 2**30:.4f} GiB were held only by reference cycles (bound "
             f"{MEMORY_CYCLE_BOUND / 2**30:.2f} GiB): what the group dropped outlived its last reference")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one GPU and check them.")
    ap.add_argument("--only", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups for a partial run (kernels: gn, attn, attn-sweep, ref; main: "
                         "main, layers, profile, fused, staged, fidelity, serve, serve f32, tier, bench; apps: apps, "
                         "prepare, "
                         "golden; cond; train: "
                         "attn-grad, train, remat, train-pixel, train-vae; dp: dp, shard, encoder-train; interop: "
                         "native, cond-train, rebuild); a partial run prints no result lines")
    # one rank of [dp]: the script re-runs itself with these
    for name in ("rank", "world", "init", "device", "backend", "shardings", "root", "tag"):
        ap.add_argument(f"--dp-{name}", default=None, help=argparse.SUPPRESS)
    # one [rebuild] recipe in a process of its own: the script re-runs itself with these
    ap.add_argument("--side", default=None, choices=REBUILD_RECIPES, help=argparse.SUPPRESS)
    ap.add_argument("--side-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= {*PHASE_GROUPS, "tier", "shard", "bench", "rebuild"}:
        ap.error(f"--only takes {PHASE_GROUPS}, tier (the [serve] phase's tier probe alone), shard (the dp "
                 "group without [dp]), bench (the main group's [bench] alone) and rebuild (the interop group's "
                 "[rebuild] alone)")
    if not (REPO / "audio_diffusion_torch" / "csrc").is_dir():
        print("chip_smoke: audio_diffusion_torch/ not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_rank is not None:
        dp_rank(int(args.dp_rank), int(args.dp_world), args.dp_init, args.dp_device, args.dp_backend,
                args.dp_shardings.split(","), Path(args.dp_root), args.dp_tag)
        return 0
    if args.side is not None:
        side_child(args.side, Path(args.side_root))
        return 0
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark} cudnn.deterministic={torch.backends.cudnn.deterministic}")
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    from audio_diffusion_torch.models import unconditional_config

    phase_build()
    if "kernels" in only:
        cfg = unconditional_config(sample_size=(32, 32), dtype="bfloat16", fused_groupnorm=True)
        gn_err, gn_t = phase_groupnorm(cfg, card, cond_config())
        at_err, at_t = phase_attention(card)
        phase_attention_sweep(card)
        phase_unet_reference()
        print(f"[time] the kernels group done at {time.perf_counter() - t_start:.1f} s")
    if {"main", "apps", "interop"} & only:
        t0 = time.perf_counter()
        pipe = build_pipeline()
        print(f"[main] built full-width latent-256 pipeline (bf16, fused GroupNorm) in "
              f"{time.perf_counter() - t0:.2f} s")
    if "main" in only:
        import tempfile

        launches, main_walls = phase_main(pipe, card)
        phase_layers(pipe, card)
        phase_fused(pipe, card, phase_profile(pipe, card))
        lap("[main], [layers], [profile], [fused]")
        staged = phase_staged(pipe, card)
        phase_fidelity(pipe, card)
        lap("[staged], [fidelity]")
        with tempfile.TemporaryDirectory() as serve_dir:
            serve_launches = phase_serve(pipe, card, Path(serve_dir))
            lap("[serve] and [tier]")
            phase_serve_f32(pipe, card)
            lap("[serve] f32")
            bench_launches = phase_bench(pipe, card, Path(serve_dir), main_walls)
        print(f"[time] the main group done at {time.perf_counter() - t_start:.1f} s")
    if "apps" in only:
        apps_launches = phase_apps(pipe, card)
        phase_prepare(card)
        phase_golden(card)
        print(f"[time] the apps group done at {time.perf_counter() - t_start:.1f} s")
    if "interop" in only:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            native_launches = phase_native(pipe, card, Path(d))
    if {"main", "apps", "interop"} & only:
        del pipe
        release_device_memory("the latent-256 pipeline's groups")
        print(f"[time] the latent-256 pipeline's groups done at {time.perf_counter() - t_start:.1f} s")
    if "tier" in only and "main" not in only:
        tier_pipe = build_pipeline()
        phase_conv(tier_pipe, card)
        phase_tier(tier_pipe, card)
        del tier_pipe
        torch.cuda.empty_cache()
    if "bench" in only and "main" not in only:
        import tempfile

        with tempfile.TemporaryDirectory() as serve_dir:
            bench_pipe = build_pipeline()
            bench_pipe.save_pretrained(serve_dir)
            phase_bench(bench_pipe, card, Path(serve_dir), None)
        del bench_pipe
        torch.cuda.empty_cache()
    if "cond" in only:
        t0 = time.perf_counter()
        cond_pipe = build_cond_pipeline()
        print(f"[cond] built the full-width conditional-latent-512 pipeline (bf16, fused GroupNorm) in "
              f"{time.perf_counter() - t0:.2f} s")
        encodings = phase_audio_encoder(card)
        cond_launches = phase_cond(cond_pipe, encodings, card)
        phase_cond_reference(cond_pipe, encodings)
        phase_cond_timing(cond_pipe, encodings, card)
        phase_fidelity(cond_pipe, card)
        phase_cond_serve(cond_pipe, encodings, card)
        del cond_pipe
        release_device_memory("the conditional group")
        print(f"[time] the conditional group done at {time.perf_counter() - t_start:.1f} s")
    if "train" in only:
        import tempfile

        grad_t = phase_attention_grad(card)
        with tempfile.TemporaryDirectory() as d:
            train_launches = phase_train(card, Path(d))
            remat_launches = phase_remat(card, Path(d))
            lap("[attn-grad], [train], [remat]")
            phase_train_profile(card)
            phase_train_pixel(card)
            phase_train_vae(card, Path(d) / "slices")
        release_device_memory("the train group")
        print(f"[time] the train group done at {time.perf_counter() - t_start:.1f} s")
    # [rebuild]'s recipes and [dp]'s ranks run in processes of their own, side by side with each other and with
    # [shard], [encoder-train] and [cond-train] here; their reports follow once they end
    with contextlib.ExitStack() as side_by_side:
        import tempfile

        sides = list(REBUILD_RECIPES) if "interop" in only or "rebuild" in only else []
        side_run = side_by_side.enter_context(side_processes(
            Path(side_by_side.enter_context(tempfile.TemporaryDirectory())), sides))
        if "dp" in only:
            dp_run = side_by_side.enter_context(dp_processes(
                card, Path(side_by_side.enter_context(tempfile.TemporaryDirectory()))))
        if "dp" in only or "shard" in only:
            shard_launches = phase_shard(card)
            phase_encoder_train(card)
            release_device_memory("[shard] and [encoder-train]")
            lap("[shard], [encoder-train]")
        if "interop" in only:
            with tempfile.TemporaryDirectory() as d:
                cond_train_launches = phase_cond_train(card, Path(d))
            lap("[cond-train]")
        if "dp" in only:
            dp_launches = dp_finish(dp_run, card)
            lap("[dp]")
        if sides:
            rebuild_launches = rebuild_finish(side_run, card)
            lap("[rebuild]")
    if {"dp", "shard", "interop", "rebuild"} & only:
        release_device_memory("the dp and interop groups")
        print(f"[time] the dp and interop groups done at {time.perf_counter() - t_start:.1f} s")
    if only != set(PHASE_GROUPS):  # a partial run
        print(f"chip_smoke: partial run of {sorted(only)} done in {time.perf_counter() - t_start:.1f} s; no result")
        return 0

    pallas_gn = "audio_diffusion_tpu/ops/pallas_groupnorm.py"
    gn_row = {"name": "group_norm_silu", "route": "cuda", "source": "audio_diffusion_torch/csrc/group_norm_silu.cu",
              "replaces": f"{pallas_gn}:51, {pallas_gn}:66",
              "launches": launches["group_norm_silu"], "launches_per_request": 64 * STEPS,
              "serve_launches": serve_launches["group_norm_silu"], "apps_launches": apps_launches["group_norm_silu"],
              "cond_launches": cond_launches["group_norm_silu"], "cond_launches_per_request": COND_NORMS * STEPS,
              "train_launches": {"forward": train_launches["group_norm_silu"], "backward": 0},
              "remat_launches": {run: {"forward": v["group_norm_silu"], "backward": 0}
                                 for run, v in remat_launches.items()},
              "dp_launches": {run: {"forward": v["group_norm_silu"], "backward": 0} for run, v in dp_launches.items()},
              "shard_launches": shard_launches["group_norm_silu"],
              "interop_launches": {"native": {k: v["group_norm_silu"] for k, v in native_launches.items()},
                                   "cond_train": cond_train_launches["group_norm_silu"]},
              "staged_launches": staged["launches"]["staged"]["group_norm_silu"],
              "encode_launches": staged["launches"]["encode"]["group_norm_silu"],
              "bench_launches": bench_launches["group_norm_silu"],
              "max_abs_err": gn_err["f32"], "bf16_max_ulps": gn_err["bf16_ulps"]}
    at_row = {"name": "flash_mha", "route": "cuda", "source": "audio_diffusion_torch/csrc/mha.cu",
              "replaces": "audio_diffusion_tpu/ops/pallas_attention.py:55", "launches": launches["flash_mha"],
              "launches_per_request": 6 * STEPS, "serve_launches": serve_launches["flash_mha"],
              "apps_launches": apps_launches["flash_mha"], "cond_launches": cond_launches["flash_mha"],
              "train_launches": {"forward": train_launches["flash_mha"],
                                 "backward": train_launches["FlashMHA.backward"]},
              "remat_launches": {run: {"forward": v["flash_mha"], "backward": v["FlashMHA.backward"]}
                                 for run, v in remat_launches.items()},
              "dp_launches": {run: {"forward": v["flash_mha"], "backward": v["FlashMHA.backward"]}
                              for run, v in dp_launches.items()},
              "shard_launches": shard_launches["flash_mha"],
              "interop_launches": {"native": {k: v["flash_mha"] for k, v in native_launches.items()},
                                   "cond_train": cond_train_launches["flash_mha"]},
              "staged_launches": staged["launches"]["staged"]["flash_mha"],
              "encode_launches": staged["launches"]["encode"]["flash_mha"],
              "bench_launches": bench_launches["flash_mha"],
              "grad_ms": grad_t["ms"], "grad_graph_ms": grad_t["graph_ms"], "grad_library_ms": grad_t["library_ms"],
              "grad_library_graph_ms": grad_t["library_graph_ms"], "max_abs_err": at_err["f32"]}
    def rebuild_column(kernel: str) -> dict:
        """``kernel``'s [rebuild] launches by recipe and stage (the UNet's training: forward and backward), the
        trained requests held against the plain versions, and bench's side run."""
        col = {"side_run": rebuild_launches["side_run"][kernel]}
        for recipe in ("latent256", "conditional_latent512"):
            col[recipe] = {stage: ({"forward": c[kernel], "backward": c["FlashMHA.backward"]}
                                   if kernel == "flash_mha" and stage == "unet" else c[kernel])
                           for stage, c in rebuild_launches[recipe].items()}
        return col

    gn_row["rebuild_launches"], at_row["rebuild_launches"] = rebuild_column("group_norm_silu"), rebuild_column(
        "flash_mha")
    keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_graph_ms")
    kernels = [{**gn_row, **{k: gn_t[k] for k in keys}}, {**at_row, **{k: at_t[k] for k in keys}}]
    for k in kernels:
        if not (k["launches"] > 0 and k["staged_launches"] > 0 and k["encode_launches"] > 0
                and k["bench_launches"] > 0):
            fail(f"kernel {k['name']} was not launched on the main path, the staged path, encode's or the "
                 f"measurement programs': {k['launches']}, {k['staged_launches']}, {k['encode_launches']}, "
                 f"{k['bench_launches']}")
    if not (train_launches["flash_mha"] > 0 and train_launches["FlashMHA.backward"] > 0):
        fail("flash_mha and its backward were not launched on the training path")
    if not (remat_launches["latent256"]["flash_mha"] > 0 and remat_launches["latent256"]["FlashMHA.backward"] > 0):
        fail(f"flash_mha and its backward were not launched on the remat training path: {remat_launches}")
    if not all(v["flash_mha"] > 0 and v["FlashMHA.backward"] > 0 for v in dp_launches.values()):
        fail(f"flash_mha and its backward were not launched on every data-parallel rank: {dp_launches}")
    if not all(v > 0 for v in shard_launches.values()):
        fail(f"the kernels were not launched on the sharded path: {shard_launches}")
    if not all(v > 0 for v in apps_launches.values()):
        fail(f"the kernels were not launched on the convenience layer's path: {apps_launches}")
    if not all(n > 0 for v in native_launches.values() for n in v.values()):
        fail(f"the kernels were not launched by the reloaded pipelines: {native_launches}")
    r256, r512 = rebuild_launches["latent256"], rebuild_launches["conditional_latent512"]
    if not (all(r256[st]["group_norm_silu"] > 0 and r256[st]["flash_mha"] > 0 for st in ("bench", "fidelity"))
            and r256["unet"]["flash_mha"] > 0 and r256["unet"]["FlashMHA.backward"] > 0
            and all(r512[st]["group_norm_silu"] > 0 for st in ("bench", "fidelity"))):
        fail(f"the kernels were not launched on the rebuild recipes' paths: {rebuild_launches}")
    if not cond_train_launches["group_norm_silu"] > 0:
        fail(f"the GroupNorm+SiLU kernel was not launched on the conditional recipe's path: {cond_train_launches}")
    print(f"(times per UNet forward at batch 32, bf16: ms by CUDA events around eager calls, host gaps included; "
          f"graph_ms replayed from a CUDA graph; library_ms: torch's F.group_norm + F.silu (two calls) and "
          f"F.scaled_dot_product_attention; grad_*: the attention backward per latent-256 UNet forward at batch 32 "
          f"beside SDPA's forward+backward; total run {time.perf_counter() - t_start:.1f} s)  [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
