"""The stage ledger of a request, by the method of the port's ``scripts/stage_ledger.py``: one staged
request (``pipe.fuse = False``) at the cell's batch makes the pipeline's stage programs (``denoise``,
``vae_decode``, ``audio``), and each is timed by CUDA events around replays of its captured graphs, the
median of ``reps`` kept. On the CPU (the tests) the stage bodies run uncaptured under the host clock."""

from __future__ import annotations

import statistics
import time

import torch

from . import traffic

STAGES = ("denoise", "vae_decode", "audio")


def _ms(fn, reps: int, device) -> float:
    fn()
    if device.type == "cuda":
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize(device)
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        times = [a.elapsed_time(b) for a, b in pairs]
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


@torch.inference_mode()
def stage_ms(pipe, cfg: dict, mix: dict, seed: int, index: int, reps: int) -> dict:
    """{stage: median ms} of the cell's request signature, run through the staged programs."""
    inp = traffic.closed_inputs(cfg, mix, seed, index, pipe.device)
    fuse = pipe.fuse
    try:
        pipe.fuse = False
        pipe(noise=inp["noise"], encoding=inp.get("encoding"), gl_phase=inp["gl_phase"], steps=mix["steps"],
             eta=mix["eta"], return_arrays=True, pcm16=mix["pcm16"])
    finally:
        pipe.fuse = fuse
    out = {}  # the fused program is keyed "fused"; the staged request made one program of each stage
    for key, prog in pipe._compiled.items():
        if key[0] in STAGES:
            if prog.graphs is not None:
                def run(prog=prog):
                    for g in prog.graphs:
                        g.replay()
            else:
                def run(prog=prog):
                    for j in range(len(prog.segments)):
                        pipe._stage_body(prog, j)
            out[key[0]] = _ms(run, reps, pipe.device)
    return out
