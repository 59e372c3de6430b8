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
             50 DDIM steps through ``AudioDiffusionPipeline.__call__``; the
             kernels' launch counters must show the path went through them
  5. fidelity  Griffin-Lim round trip and bf16-vs-f32 VAE round trip gates
  6. serve   the same pipeline saved with ``save_pretrained`` (diffusers
             layout), loaded through ``serving.make_server`` (bf16, fused
             GroupNorm, tiers up to 8) and asked over HTTP by concurrent
             clients: 16 generations, 4 audio-to-audio at start_step 25 and 4
             at eta 0.5, all at 50 steps; every response a 200 with a full
             wav; 64 GroupNorm+SiLU and 6 attention launches per denoise step
             of every served batch; wav and json PCM identical; a seed bitwise
             the same with other companions in its tier and, at eta 0, at
             tier 1 and tier 8 (the batcher runs batches with cuDNN off);
             /healthz figures. [tier]: every torch call of a batch-8 UNet
             forward re-run on row 0 alone, with cuDNN's defaults, with
             cudnn.deterministic and with cuDNN off: the calls whose row
             depends on the batch, the drift they cause, the forward's time
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
             peak memory and a profile of 2 steps
 11. train-pixel  the pixel-256 UNet (bf16, batch 4) takes 3 steps through
             ``make_train_step``: the mma route under autograd
 12. train-vae  the 256 LDM VAE with its PatchGAN, generator and
             discriminator steps alternating, the adversarial terms on from step 2
Then one JSON line with each kernel's launches (``launches``: the [main]
requests; ``serve_launches``: the [serve] traffic; ``apps_launches``: the
[apps] calls; ``cond_launches``: the
[cond] requests; ``train_launches``: the [train] run's forwards and
backwards), error and times, the card's
name and power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero at once and prints no result.
"""

from __future__ import annotations

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
GL_BOUND = 2.41 + 1.1  # bench.py:212-214, 256x256 hop 512
VAE_BOUND = 2.0  # bench.py:231-232, uint8 MAE
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
GL_BOUND_512 = 3.21 + 1.1  # bench.py:211-213, 512x512 hop 512
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
PIXEL_BATCH, PIXEL_STEPS = 4, 3
VAE_TRAIN_BATCH, VAE_TRAIN_STEPS, VAE_DISC_START = 4, 4, 2
# The convenience layer on the latent-256 pipeline: 2 s overlaps (the stitch functions' default)
APPS_OVERLAP_SECS, APPS_OUTPAINT_WINDOWS, APPS_REMIX_WINDOWS, APPS_REMIX_START = 2.0, 2, 3, 25


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    from audio_diffusion_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load()
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
    import torch

    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, VAEConfig, unconditional_config
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    vae_cfg = VAEConfig(sample_size=256, dtype="bfloat16")
    vae = AutoencoderKL(vae_cfg).init_params(torch.Generator().manual_seed(1))
    cfg = unconditional_config(sample_size=vae_cfg.latent_hw(256, 256), dtype="bfloat16", fused_groupnorm=True)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0))
    mel = Mel(x_res=256, y_res=256, hop_length=512, device="cuda")
    return AudioDiffusionPipeline(unet, mel, DDIMScheduler(), vae, device="cuda")


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

    for c in counters:
        c.launches = 0
    for b, seed in REQUESTS:
        before = [c.launches for c in counters]
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, audio = pipe(batch_size=b, steps=STEPS, generator=gen, return_arrays=True)
        pcm = pcm16_quantize(audio)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        print(f"[main] request batch={b}: {wall:.4f} s wall (warm-up call {warm[b]:.4f} s), "
              f"{b / wall:.4f} samples/s, "
              f"launches group_norm_silu/flash_mha {delta}, audio {tuple(pcm_np.shape)} int16 peak "
              f"{int(np.abs(pcm_np.astype(np.int32)).max())}, spectrogram std {raw_np.std():.3f}  [{card}]")
    launches = {c.__name__: c.launches for c in counters}
    print(f"[main] ok: {len(REQUESTS)} requests at {STEPS} steps; launch counters {launches}")
    return launches


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


def cross_tier_drift(pipe, seed: int, tier: int) -> dict:
    """Where one row's result departs between batch 1 and batch ``tier``
    (the row's noise the same, the rest other seeds): max abs difference of
    one UNet forward at the first timestep, of the latents after ``STEPS``
    DDIM steps, and of the uint8 spectrograms, in the pipeline's bf16 and in
    f32 (TF32 off), with that max relative to the max |value|."""
    import numpy as np
    import torch

    from audio_diffusion_torch.models import AutoencoderKL, UNet2D
    from audio_diffusion_torch.pipelines.pipeline import LATENT_SCALE, postprocess_images
    from audio_diffusion_torch.serving.batcher import _noise_for_seed

    h, w = pipe.sample_hw
    dev = pipe.device
    x = torch.from_numpy(np.stack([_noise_for_seed(seed + i, h, w, 1) for i in range(tier)])).to(dev)
    schedule = pipe.scheduler.schedule(STEPS)
    out = {}
    for name in ("bf16", "f32"):
        unet, vae = pipe.unet, pipe.vqvae
        if name == "f32":
            unet = UNet2D(dataclasses.replace(unet.config, dtype="float32")).to(dev).eval()
            unet.load_state_dict(pipe.unet.state_dict())
            vae = AutoencoderKL(dataclasses.replace(vae.config, dtype="float32")).to(dev).eval()
            vae.load_state_dict(pipe.vqvae.state_dict())
        rows = {}
        with torch.inference_mode():
            for b in (1, tier):
                z = x[:b].contiguous()
                for i, t in enumerate(schedule.timesteps):
                    eps = unet(z, torch.full((b,), int(t), device=dev))
                    if i == 0:
                        first = eps[:1].clone()
                    z = pipe.scheduler.step(eps, int(t), z, schedule)
                rows[b] = (first, z[:1].clone(), postprocess_images(vae.decode(z / LATENT_SCALE))[:1].int())
        for i, what in enumerate(("first forward", "latents", "uint8")):
            a, b = rows[1][i].float(), rows[tier][i].float()
            d = (a - b).abs().max().item()
            out[f"{name} {what}"] = (d, d / max(b.abs().max().item(), 1e-30))
        del unet, vae
    return out


def tier_layers(pipe, seed: int, tier: int) -> dict:
    """Which operations give a row another result in a batch of ``tier`` than
    alone, under the current cuDNN settings. One UNet forward (the first
    timestep, the pipeline's dtype) at batch ``tier`` runs under a
    TorchFunctionMode that re-runs every torch call whose tensor arguments
    and result have ``tier`` rows on row 0 alone (those arguments cut to
    their first row) and compares that with row 0 of the batched result.
    Returns the first call in forward order whose row differs, and per
    function the calls, the calls that differ, the largest difference and
    the input shapes of the calls that differ."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode

    from audio_diffusion_torch.serving.batcher import _noise_for_seed

    def rows(a):
        return torch.is_tensor(a) and a.dim() > 0 and a.shape[0] == tier

    per_func, first = {}, []

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
                    st = per_func.setdefault(name, {"calls": 0, "differ": 0, "max_diff": 0.0, "shapes": set()})
                    st["calls"] += 1
                    if d > 0:
                        st["differ"] += 1
                        st["max_diff"] = max(st["max_diff"], d)
                        st["shapes"].add(tuple(next(a for a in args if rows(a)).shape[1:]))
                        if not first:
                            first.append((name, d))
            return out

    h, w = pipe.sample_hw
    x = torch.from_numpy(np.stack([_noise_for_seed(seed + i, h, w, 1) for i in range(tier)])).to(pipe.device)
    t = int(pipe.scheduler.schedule(STEPS).timesteps[0])
    with torch.inference_mode(), Probe():
        pipe.unet(x, torch.full((tier,), t, device=pipe.device))
    return {"first": first[0] if first else None, "per_func": per_func}


def phase_tier(pipe, card: str) -> dict:
    """Queue 3 item 1: tier 1 against tier SERVE_TIER, layer by layer, with
    cuDNN's defaults, with ``cudnn.deterministic``, and with cuDNN off
    (``cudnn.benchmark`` stays False, TF32 is off), the end-to-end drift and
    the batch-SERVE_TIER UNet forward's time (CUDA events) under each."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled)
    h, w = pipe.sample_hw
    x = torch.randn((32, h, w, 1), generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    t = torch.full((32,), 500, device="cuda")
    out = {}
    try:
        for name, det, enabled in (("default", False, True), ("cudnn.deterministic", True, True),
                                   ("cudnn off", False, False)):
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, False
            torch.backends.cudnn.enabled = enabled
            layers = tier_layers(pipe, 1000, SERVE_TIER)
            drift = cross_tier_drift(pipe, 1000, SERVE_TIER)
            with torch.inference_mode():
                fwd_ms = {b: (cuda_time_ms(lambda: pipe.unet(x[:b], t[:b]), 10),
                              graph_time_ms(lambda: pipe.unet(x[:b], t[:b]), 10)) for b in (1, SERVE_TIER, 32)}
            out[name] = (layers, drift, fwd_ms)
            first = layers["first"]
            print(f"[tier] {name} (cudnn.enabled {enabled}, benchmark False, deterministic {det}; UNet forward ms, "
                  "events / graph, at batch " + ", ".join(f"{b}: {e:.4f} / {g:.4f}" for b, (e, g) in fwd_ms.items())
                  + "): first call whose row 0 differs "
                  f"alone and in batch {SERVE_TIER}: {first[0] + f' (max diff {first[1]:.4g})' if first else 'none'}; "
                  "calls whose row 0 differs, per function: " + "; ".join(
                      f"{k} {v['differ']}/{v['calls']} (max {v['max_diff']:.4g}, input shapes "
                      f"{sorted(v['shapes'])[:4]})" for k, v in layers["per_func"].items() if v["differ"])
                  + f" (of {sum(v['calls'] for v in layers['per_func'].values())} calls checked)"
                  + "; end to end: " + "; ".join(f"{k} {d:.4g}" for k, (d, _) in drift.items()) + f"  [{card}]")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, torch.backends.cudnn.enabled = saved
    return out


def phase_serve(pipe, card: str):
    """Save the full-width pipeline in the diffusers layout, load it through
    ``make_server`` (bf16, fused GroupNorm) and answer concurrent HTTP
    requests: pure generation, audio-to-audio at start_step 25 and eta > 0,
    all at 50 steps. The kernels' counters must show every served batch went
    through both kernels."""
    import base64
    import io
    import tempfile
    import wave

    import numpy as np
    import torch

    from audio_diffusion_torch.ops import attention as at
    from audio_diffusion_torch.ops import fused_groupnorm as gn
    from audio_diffusion_torch.serving import make_server

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        pipe.save_pretrained(d)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        server = make_server(d, dtype="bfloat16", fused_groupnorm=True, device="cuda", port=0, max_batch=SERVE_TIER,
                             max_wait_ms=1000, steps=STEPS, allowed_etas=[SERVE_ETA],
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
    print(f"[serve] saved the pipeline in {t_save:.2f} s, loaded it through make_server in {t_load:.2f} s (weights "
          f"and configs equal), warmed tiers {server.batcher.tiers} x eta {{0, {SERVE_ETA}}} x start_step "
          f"{{0, {SERVE_START_STEP}}} in {t_warm:.2f} s  [{card}]")

    mel = served.mel
    tt = np.arange(mel.x_res * mel.hop_length) / mel.get_sample_rate()
    clip = sum(np.sin(2 * np.pi * f * tt) * a for f, a in ((196.0, 0.4), (392.0, 0.3), (1318.5, 0.2)))
    clip_b64 = base64.b64encode((clip * 32767 / np.abs(clip).max()).astype(np.int16).tobytes()).decode()
    n_frames = (mel.x_res - 1) * mel.hop_length
    server.start()
    host, port = server.address[:2]
    counters = (gn.group_norm_silu, at.flash_mha)
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
        want = {"group_norm_silu": 64 * denoise_steps, "flash_mha": 6 * denoise_steps}
        if launches != want:
            fail(f"[serve] launches {launches} over {len(batches)} batches of {denoise_steps} denoise steps in all; "
                 f"expected {want}")
        _check_wavs(bodies, responses, mel, "[serve]")
        print(f"[serve] {len(bodies)} concurrent requests over HTTP ({SERVE_REQUESTS}) in {wall:.4f} s: "
              f"{len(bodies) / wall:.4f} requests/s; {len(batches)} batches (n/tier/denoise steps "
              f"{[(s['n'], s['tier'], s['steps']) for s in batches]}); launches {launches} = 64 and 6 per denoise "
              f"step of every batch; all 200 with {n_frames}-frame wavs  [{card}]")

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
        print(f"[serve] ok: wav and json PCM identical; seed 1000 bitwise the same spectrogram with other companions "
              f"at tier {SERVE_TIER} (eta 0) and tier 4 (eta {SERVE_ETA}), and alone at tier 1 (eta 0) as at tier "
              f"{SERVE_TIER}  [{card}]")
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


def phase_layers(pipe, card: str):
    """Per-layer device times at batch 32 (CUDA events), for the breakdown."""
    import torch

    from audio_diffusion_torch.pipelines.pipeline import LATENT_SCALE, postprocess_images

    b = 32
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b, 32, 32, 1), generator=gen, device="cuda")
    t = torch.full((b,), 500, dtype=torch.long, device="cuda")
    sched = pipe.scheduler.schedule(STEPS)
    with torch.inference_mode():
        unet_ms = cuda_time_ms(lambda: pipe.scheduler.step(pipe.unet(x, t), 500, x, sched), 10)
        img = pipe.vqvae.decode(x / LATENT_SCALE)
        vae_ms = cuda_time_ms(lambda: pipe.vqvae.decode(x / LATENT_SCALE), 3)
        post_ms = cuda_time_ms(lambda: postprocess_images(img), 10)
        raw = postprocess_images(img)
        gl = {p: cuda_time_ms(lambda: pipe.mel.images_to_audio(raw, generator=gen, projection=p), 2)
              for p in ("fft", "matmul")}
    print(f"[layers] batch 32 device ms: unet_step {unet_ms:.4f} (x{STEPS} = {unet_ms * STEPS:.2f}), "
          f"vae_decode {vae_ms:.4f}, postprocess {post_ms:.4f}, nnls+gl fft {gl['fft']:.4f}, "
          f"nnls+gl matmul {gl['matmul']:.4f}  [{card}]")
    return {"unet_step": unet_ms, "vae_decode": vae_ms, "postprocess": post_ms, "gl": gl}


def phase_profile(pipe, card: str):
    """torch.profiler over one batch-32 request: device busy share of the
    wall time and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(104)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(batch_size=32, steps=STEPS, generator=gen, return_arrays=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    print(f"[profile] batch 32, {STEPS} steps, profiled wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms = {100 * busy / wall_us:.2f}% (idle {100 - 100 * busy / wall_us:.2f}%)  [{card}]")
    for e in sorted(events, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    ours = []
    for name in ("gn_silu_warp_kernel", "gn_silu_cta_kernel", "mha_small_kernel", "mha_mma_kernel",
                 "mha_simt_kernel"):
        hits = [e for e in events if name in e.key]
        ms = sum(dev_us(e) for e in hits) / 1e3
        ours.append(f"{name} {ms:.3f} ms / {sum(e.count for e in hits)}x ({ms / STEPS:.4f} ms per UNet forward)")
    print("[profile] this repo's kernels, device time in that request: " + "; ".join(ours))
    copies = [e for e in prof.key_averages() if e.key == "aten::copy_"]
    print(f"[profile] aten::copy_ in that request: {sum(e.count for e in copies)} calls, "
          f"{sum(dev_us(e) for e in copies) / 1e3:.3f} ms device time  [{card}]")


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


def phase_fidelity(pipe, card: str, gl_bound: float = GL_BOUND):
    import numpy as np
    import torch

    from audio_diffusion_torch.models import AutoencoderKL

    mel = pipe.mel
    rng = np.random.default_rng(0)
    tt = np.arange(mel.slice_size) / mel.get_sample_rate()
    audio = sum(np.sin(2 * np.pi * f * tt) * a for f, a in ((220.0, 0.5), (587.33, 0.3), (1760.0, 0.2)))
    audio = (audio + 0.1 * rng.standard_normal(mel.slice_size)).astype(np.float32)
    img = mel.spectrogram_images_from_audio(audio[None])
    maes = {}
    for proj in ("fft", "matmul"):
        rec = mel.images_to_audio(img, projection=proj)[0]
        rec = torch.nn.functional.pad(rec, (0, mel.slice_size - rec.shape[0]))
        img2 = mel.spectrogram_images_from_audio(rec[None])
        maes[proj] = (img.float() - img2.float()).abs().mean().item()
        if not maes[proj] < gl_bound:
            fail(f"GL round-trip MAE ({proj}) {maes[proj]:.4f} >= {gl_bound}")

    x = (img.float() / 255.0 * 2 - 1)[..., None]  # (1, y_res, x_res, 1)
    vae32 = AutoencoderKL(dataclasses.replace(pipe.vqvae.config, dtype="float32"))
    vae32.load_state_dict(pipe.vqvae.state_dict(), strict=True)
    vae32 = vae32.to("cuda").eval()
    with torch.inference_mode():
        rec_b = pipe.vqvae.decode(pipe.vqvae.encode(x).mode()).float()
        rec_32 = vae32.decode(vae32.encode(x).mode())
    vae_mae = (rec_b - rec_32).abs().mean().item() * 127.5
    if not vae_mae < VAE_BOUND:
        fail(f"bf16 VAE round trip drifted {vae_mae:.4f} uint8-MAE from f32 (bound {VAE_BOUND})")
    print(f"[fidelity] ok at {mel.y_res}x{mel.x_res} hop {mel.hop_length}: gl_roundtrip_mae fft {maes['fft']:.4f}, "
          f"matmul {maes['matmul']:.4f} (< {gl_bound:.2f}); vae_dtype_mae {vae_mae:.4f} (< {VAE_BOUND:.2f})  [{card}]")
    return maes, vae_mae


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
    t = torch.full((b,), 500, dtype=torch.long, device="cuda")
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
    counters = (gn.group_norm_silu, at.flash_mha)
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
        if launches != {"group_norm_silu": COND_NORMS * STEPS, "flash_mha": 0}:
            fail(f"[cond-serve] launches {launches}, expected {COND_NORMS} GroupNorm+SiLU per denoise step, no attention")
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
    torch.cuda.reset_peak_memory_stats()
    results = []
    with _LogLines() as log:
        for max_steps in (TRAIN_STEPS, TRAIN_RESUME_TO):
            t0 = time.perf_counter()
            results.append(run_training(run(max_steps), train))
            torch.cuda.synchronize()
            results[-1]["wall"] = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
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
          f"{second['wall']:.2f} s; max_memory_allocated {peak_gib:.4f} GiB  [{card}]")
    return launches


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
    """A pipeline whose every call must launch the GroupNorm+SiLU kernel 64
    times and flash_mha 6 times per denoise step (the UNet's forwards, counted
    by a hook), with STEPS - start_step steps; each call's wall time, the
    shape of its raw_audio and its generator's state are kept."""

    def __init__(self, pipe, name: str):
        self.pipe, self.name, self.calls, self.forwards = pipe, name, [], 0
        self.hook = pipe.unet.register_forward_pre_hook(self._forward)

    def _forward(self, *_):
        self.forwards += 1

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, **kw):
        import numpy as np
        import torch

        from audio_diffusion_torch.ops import attention as at
        from audio_diffusion_torch.ops import fused_groupnorm as gn

        gen = kw.get("generator")
        state = gen.get_state() if gen is not None else None
        before, f0 = (gn.group_norm_silu.launches, at.flash_mha.launches), self.forwards
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.pipe(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f = self.forwards - f0
        delta = (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1])
        if f != STEPS - kw.get("start_step", 0) or delta != (64 * f, 6 * f):
            fail(f"[apps] {self.name}: {f} denoise steps with launches (group_norm_silu, flash_mha) {delta}; "
                 f"expected {STEPS - kw.get('start_step', 0)} steps and 64 and 6 launches per step")
        raw = kw.get("raw_audio")
        self.calls.append({"wall": wall, "steps": f, "state": state,
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
        counted.hook.remove()
        app_counted.hook.remove()

    launches = {c.__name__: c.launches for c in counters}
    calls = counted.calls[1:] + app_counted.calls
    steps = sum(c["steps"] for c in calls)
    if launches != {"group_norm_silu": 64 * steps, "flash_mha": 6 * steps}:
        fail(f"[apps] launches {launches} over {steps} denoise steps")
    print(f"[apps] saved + loaded through AudioDiffusion(dtype=bfloat16, fused_groupnorm=True) in {t_load:.2f} s, "
          f"apps.get_model {t_app_load:.2f} s; walls: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in walls.items())
          + f"; loop_it of the generated clip: {'none' if generated_loop is None else len(generated_loop)} samples  "
          f"[{card}]")
    print(f"[apps] ok: {len(calls)} pipeline calls, {steps} denoise steps, launches {launches} = 64 and 6 per denoise "
          f"step of every call; lengths by the stitch arithmetic; serial remix pinned (first window bitwise a direct "
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


PHASE_GROUPS = ("kernels", "main", "apps", "cond", "train")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port's paths on one GPU and check them.")
    ap.add_argument("--only", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups for a partial run (kernels: gn, attn, attn-sweep, ref; main: "
                         "main, layers, profile, fidelity, serve, tier; apps: apps, prepare, golden; cond; train: "
                         "attn-grad, train, train-pixel, train-vae); a partial run prints no result lines")
    only = set(ap.parse_args(argv).only.split(","))
    if not only <= {*PHASE_GROUPS, "tier"}:
        ap.error(f"--only takes {PHASE_GROUPS} and tier (the [serve] phase's tier probe alone)")
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
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark} cudnn.deterministic={torch.backends.cudnn.deterministic}")
    t_start = time.perf_counter()

    from audio_diffusion_torch.models import unconditional_config

    phase_build()
    if "kernels" in only:
        cfg = unconditional_config(sample_size=(32, 32), dtype="bfloat16", fused_groupnorm=True)
        gn_err, gn_t = phase_groupnorm(cfg, card, cond_config())
        at_err, at_t = phase_attention(card)
        phase_attention_sweep(card)
        phase_unet_reference()
    if "main" in only or "apps" in only:
        t0 = time.perf_counter()
        pipe = build_pipeline()
        print(f"[main] built full-width latent-256 pipeline (bf16, fused GroupNorm) in "
              f"{time.perf_counter() - t0:.2f} s")
    if "main" in only:
        launches = phase_main(pipe, card)
        phase_layers(pipe, card)
        phase_profile(pipe, card)
        phase_fidelity(pipe, card)
        serve_launches = phase_serve(pipe, card)
    if "apps" in only:
        apps_launches = phase_apps(pipe, card)
        phase_prepare(card)
        phase_golden(card)
    if "main" in only or "apps" in only:
        del pipe
        torch.cuda.empty_cache()
    if "tier" in only and "main" not in only:
        phase_tier(build_pipeline(), card)
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
        phase_fidelity(cond_pipe, card, GL_BOUND_512)
        phase_cond_serve(cond_pipe, encodings, card)
        del cond_pipe
        torch.cuda.empty_cache()
    if "train" in only:
        import tempfile

        grad_t = phase_attention_grad(card)
        with tempfile.TemporaryDirectory() as d:
            train_launches = phase_train(card, Path(d))
            phase_train_profile(card)
            phase_train_pixel(card)
            phase_train_vae(card, Path(d) / "slices")
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
              "max_abs_err": gn_err["f32"], "bf16_max_ulps": gn_err["bf16_ulps"]}
    at_row = {"name": "flash_mha", "route": "cuda", "source": "audio_diffusion_torch/csrc/mha.cu",
              "replaces": "audio_diffusion_tpu/ops/pallas_attention.py:55", "launches": launches["flash_mha"],
              "launches_per_request": 6 * STEPS, "serve_launches": serve_launches["flash_mha"],
              "apps_launches": apps_launches["flash_mha"], "cond_launches": cond_launches["flash_mha"],
              "train_launches": {"forward": train_launches["flash_mha"],
                                 "backward": train_launches["FlashMHA.backward"]},
              "grad_ms": grad_t["ms"], "grad_graph_ms": grad_t["graph_ms"], "grad_library_ms": grad_t["library_ms"],
              "grad_library_graph_ms": grad_t["library_graph_ms"], "max_abs_err": at_err["f32"]}
    keys = ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_graph_ms")
    kernels = [{**gn_row, **{k: gn_t[k] for k in keys}}, {**at_row, **{k: at_t[k] for k in keys}}]
    for k in kernels:
        if not k["launches"] > 0:
            fail(f"kernel {k['name']} was not launched on the main path")
    if not (train_launches["flash_mha"] > 0 and train_launches["FlashMHA.backward"] > 0):
        fail("flash_mha and its backward were not launched on the training path")
    if not all(v > 0 for v in apps_launches.values()):
        fail(f"the kernels were not launched on the convenience layer's path: {apps_launches}")
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
