"""The open loop: independent users' 1-clip requests into ``DynamicBatcher.submit`` (the entry the HTTP
server's POST handler calls) at the due times of the mix's arrival process, whatever the system does
(``core/drivers.py::run_open``).

A mix of this mode: ``arrivals`` (``benchmark/arrivals/<arrivals>.py``) and its parameters; ``steps``,
``eta``, ``pcm16``; the batcher's ``max_batch``, ``max_wait_ms`` and ``batch_policy``; ``check_requests``
(served requests judged), ``drain_s`` (the wait for results past the window's close) and ``trace_s``: with
``--trace 1``, the window runs untraced as without it, and then the arrivals of its last ``trace_s`` seconds are
sent again under the profiler, started and stopped with the batcher idle (``core/drivers.py::traced_tail``).
"""

import time
import types

import numpy as np
import torch

from benchmark.core import drivers, named, profile, traffic
from benchmark.core.cell import free, sample
from benchmark.core.errors import CellError


def served_phase(device, tier: int, row: int, mel: dict) -> torch.Tensor:
    """The initial Griffin-Lim phase a served row gets: the batcher hands no phase and no generator, so the
    pipeline draws it batch-shaped from a fresh seed-0 generator on its device."""
    g = torch.Generator(device=device).manual_seed(0)
    return 2.0 * np.pi * torch.rand((tier, mel["x_res"], mel["n_fft"] // 2 + 1), generator=g, device=device)[row]


def served_family(cfg: dict):
    """The configuration's family, which has to say what a served request's inputs are (``served_inputs``)."""
    fam = named.family(cfg)
    if not hasattr(fam, "served_inputs"):
        raise CellError(f"the family {cfg.get('family', named.DEFAULT_FAMILY)!r} has no served_inputs: "
                        "it cannot be put in an open-loop cell")
    return fam


def run(cell, seed, seconds, trace, device, t_start, out):
    from audio_diffusion_torch.serving.batcher import DynamicBatcher

    cfg, mix = cell.cfg, cell.mix
    fam = served_family(cfg)
    pipe = fam.program(cfg, seed, device)
    batcher = DynamicBatcher(pipe, max_batch=mix["max_batch"], max_wait_ms=mix["max_wait_ms"], steps=mix["steps"],
                             eta=mix["eta"], pcm16=mix["pcm16"], batch_policy=mix["batch_policy"])
    try:
        batcher.warmup()
        out["setup_s"] = time.perf_counter() - t_start
        tracer = profile.Tracer() if trace and device.type == "cuda" else None
        if tracer:  # the profiler's first start in a process sets up CUPTI, seconds of it: not in the window
            tracer.start()
            tracer.stop()
        res = drivers.run_open(batcher, mix, seed, seconds)
        tail = drivers.traced_tail(batcher, mix, res, tracer) if tracer else None
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        batcher.close()
    out["attempted"], out["failed"] = len(res.due), res.failed
    out["e2e"] = {"p95_latency_s": drivers.p95(res.latency_s)}
    out["late"] = {"late_p50_s": float(np.median(res.late_s)), "late_max_s": float(res.late_s.max()),
                   "shed": int(sum(res.shed)), "errors": len(res.errors), "completed": res.completed,
                   "batches": len(res.batches), "queued_at_close": res.queued_at_close}
    if tail is not None:
        out["late"]["traced_tail"] = f"{tail.completed} of {len(tail.due)}"
    # the serving readers take every batch of the window, which the profiler never slows
    out["ctx"] = types.SimpleNamespace(cfg=cfg, mix=mix, window=res, batches=res.batches,
                                       trace=tracer.trace if tail is not None else None)
    del pipe, batcher
    free()
    problems = [f"request {j}: {e}" for j, e in sorted(res.errors.items())[:3]]
    if tail is not None:
        problems += [f"traced request {j}: {e}" for j, e in sorted(tail.errors.items())[:3]]
    # Which batch and row served each request: the worker serves one settings group first come, first served,
    # and the finisher records each batch's rows and tier in order.
    accepted = [j for j in range(len(res.due)) if not res.shed[j]]
    place, k = {}, 0
    for s in res.batches:
        for r in range(s["n"]):
            if k < len(accepted):
                place[accepted[k]] = (s["tier"], r)
            k += 1
    if k != len(accepted):
        problems.append(f"the batches served {k} rows for {len(accepted)} accepted requests")
    out["problems"] += problems
    rows = []
    for j in sample(seed, sorted(res.results), mix["check_requests"]):
        if j not in place:
            continue
        r = res.results[j]
        rows.append(dict(fam.served_inputs(cfg, res.seeds[j]), image=r.image, audio=r.audio,
                         gl_phase=served_phase(device, *place[j], cfg["mel"])))
    out["rows"] = rows
    out["checked"] = f"{len(rows)} of {res.completed} served requests"


def control_rows(cell, seed, device) -> list:
    """Rows as a run of the cell would check them, without the program's outputs: ``check_requests`` users'
    noise, each at a row of a full largest tier."""
    cfg, mix = cell.cfg, cell.mix
    fam = served_family(cfg)
    return [dict(fam.served_inputs(cfg, s), gl_phase=served_phase(device, mix["max_batch"], r % mix["max_batch"],
                                                                  cfg["mel"]))
            for r, s in enumerate(traffic.user_seeds(seed, mix["check_requests"]))]
