"""Sustained serving throughput: closed-loop clients through the dynamic
batcher against the same pipeline driven directly at ``--max_batch`` (the
counterpart of ``scripts/bench_serving.py``).

    python -m audio_diffusion_torch.scripts.bench_serving --model DIR \\
        --clients 64 --max_batch 32 --seconds 20 --dtype bfloat16

DIR is a saved pipeline (``AudioDiffusionPipeline.save_pretrained``, either
layout), loaded with the GroupNorm+SiLU kernel on. Each of ``--clients``
threads submits a request to ``serving.DynamicBatcher``, waits for its result
and submits the next, for ``--seconds`` (HTTP parsing is left out: this
isolates the batching layer, its queueing, padding, host noise and fan-out).
A request that raises fails the run. The ceiling is the pipeline called
directly at ``--max_batch`` with the batcher's settings, inside the batcher's
window (``utils/batch_invariant.py``: cuDNN off on the card, as every served
batch runs), so it replays the program the batcher's warmup captured and
``batching_efficiency`` reads the batching layer alone.

Prints one JSON line: ``serving_samples_per_sec``, ``direct_samples_per_sec``,
``batching_efficiency``, ``clients``, ``max_batch``, ``start_step``,
``latency`` (the batcher's ``latency_summary``), and ``served``, ``failed``,
``config`` and ``device`` beside them. Progress goes to stderr.
"""

import argparse
import contextlib
import sys
import threading
import time

import numpy as np
import torch

from ..parallel import make_mesh
from ..pipelines import AudioDiffusionPipeline
from ..serving import DynamicBatcher
from ..utils import batch_invariant
from ..utils.measure import device_block, emit, resolve_device, synchronize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--clients", type=int, default=64,
                   help="concurrent closed-loop clients (each waits for its result, then submits the next request)")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--batch_policy", type=str, default="snap", choices=["snap", "pad"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--start_step", type=int, default=0,
                   help="audio-to-audio: every client submits a synthetic clip re-noised to this step")
    p.add_argument("--seconds", type=float, default=20.0, help="measurement window")
    p.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"])
    p.add_argument("--mesh_data", type=int, default=None,
                   help="shard serving over N devices (the first N cards; tiers become multiples of N)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    device = resolve_device(a.device)
    if a.mesh_data is not None and device.type == "cuda" and a.mesh_data > torch.cuda.device_count():
        raise ValueError(f"--mesh_data {a.mesh_data} needs {a.mesh_data} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    pipe = AudioDiffusionPipeline.from_pretrained(a.model, dtype=a.dtype, fused_groupnorm=True, device=device)
    if a.mesh_data is not None:
        devices = ([torch.device("cuda", i) for i in range(a.mesh_data)] if device.type == "cuda"
                   else [device] * a.mesh_data)
        pipe.shard(make_mesh(num_data=a.mesh_data, devices=devices))
    batcher = DynamicBatcher(pipe, max_batch=a.max_batch, max_wait_ms=a.max_wait_ms, steps=a.steps,
                             batch_policy=a.batch_policy, pcm16=True,
                             allowed_start_steps=(a.start_step,) if a.start_step else None)
    try:
        print(f"warming up tiers {batcher.tiers}...", file=sys.stderr, flush=True)
        batcher.warmup()
        return _measure(a, pipe, batcher, device)
    finally:
        batcher.close()


def _measure(a, pipe, batcher, device) -> dict:
    clip = None
    if a.start_step:
        t = np.arange(pipe.mel.x_res * pipe.mel.hop_length, dtype=np.float32) / pipe.mel.get_sample_rate()
        clip = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)

    # --- batched serving: closed-loop clients
    stop = threading.Event()
    served = [0] * a.clients
    failures = []
    t_deadline = time.monotonic() + a.seconds

    def client(i):
        seed = i
        try:
            while not stop.is_set():
                batcher.submit(seed=seed, audio=clip, start_step=a.start_step).result()
                served[i] += 1
                seed += a.clients
                if time.monotonic() >= t_deadline:
                    stop.set()
        except Exception as e:  # a failed request ends the run: record it and stop every client
            failures.append(f"client {i}: {type(e).__name__}: {e}")
            stop.set()

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(a.clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=a.seconds + 600)
    elapsed = time.monotonic() - t0
    if any(t.is_alive() for t in threads):
        failures.append("a client did not finish within the window + 600 s")
    if failures:
        raise RuntimeError(f"{len(failures)} request(s) failed: {failures[:3]}")
    serving_rate = sum(served) / elapsed

    # --- ceiling: the same pipeline driven directly at max_batch, as the batcher runs a batch
    h, w = pipe.sample_hw
    c = pipe.unet.config.in_channels
    noise = np.random.default_rng(0).standard_normal((a.max_batch, h, w, c)).astype(np.float32)
    raw_audio = np.tile(clip, (a.max_batch, 1)) if clip is not None else None
    direct_kw = dict(noise=noise, steps=batcher.default_steps, start_step=a.start_step, raw_audio=raw_audio,
                     return_arrays=True, pcm16=True)

    def direct():
        gens = [torch.Generator(device=pipe.device).manual_seed(0) for _ in range(a.max_batch)]
        with batch_invariant.window() if device.type == "cuda" else contextlib.nullcontext():
            raw, audio = pipe(step_generator=gens, **direct_kw)
        return audio.cpu()  # to the host, as the batcher's finisher copies

    programs = len(pipe._compiled)
    direct()
    made = len(pipe._compiled) - programs
    n = 0
    synchronize(device)
    t0 = time.monotonic()
    while time.monotonic() - t0 < max(5.0, a.seconds / 3):
        direct()
        n += a.max_batch
    direct_rate = n / (time.monotonic() - t0)
    return emit({
        "serving_samples_per_sec": serving_rate,
        "direct_samples_per_sec": direct_rate,
        "batching_efficiency": serving_rate / direct_rate,
        "clients": a.clients,
        "max_batch": a.max_batch,
        "start_step": a.start_step,
        "latency": batcher.latency_summary(),
        "served": sum(served),
        "failed": len(failures),
        "seconds": elapsed,
        "config": {"model": a.model, "dtype": pipe.unet.config.dtype, "tiers": list(batcher.tiers),
                   "steps": batcher.default_steps, "batch_policy": a.batch_policy, "max_wait_ms": a.max_wait_ms,
                   "mesh_data": a.mesh_data, "direct_programs_made": made},
        "device": device_block(device),
    })


if __name__ == "__main__":
    main()
