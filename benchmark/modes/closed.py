"""The closed loop: one caller sends requests of the mix's ``batch`` rows back to back through the configuration's
family's ``call`` (``core/drivers.py::run_closed``), each request's inputs drawn on the card from (seed, request).

A mix of this mode: ``batch``, ``steps``, ``eta``, ``pcm16``; ``check_requests`` (how many of the window's
requests are judged) and ``trace_requests`` (the traced sub-window).
"""

import time
import types

import torch

from benchmark.core import drivers, named, profile, traffic
from benchmark.core.cell import free, sample
from benchmark.core.errors import CellError


def _programs(pipe) -> int:
    """How many programs (captured graphs) the pipeline holds: none for one that captures nothing."""
    return len(getattr(pipe, "_compiled", ()))


def run(cell, seed, seconds, trace, device, t_start, out):
    cfg, mix = cell.cfg, cell.mix
    pipe = named.family(cfg).program(cfg, seed, device)
    drivers.run_closed(pipe, cfg, mix, seed, count=1, first=0, keep=False)  # captures the request's graph
    out["setup_s"] = time.perf_counter() - t_start
    programs = _programs(pipe)
    res = drivers.run_closed(pipe, cfg, mix, seed, seconds=seconds, first=1)
    if _programs(pipe) != programs:
        raise CellError("the window made a program: the warm-up missed the timed signature")
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out["attempted"], out["failed"] = res.requests, 0
    out["e2e"] = {"samples_per_s": res.rows / res.window_s}
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, window=res, trace=None, traced_requests=0)
    if trace and device.type == "cuda":
        _, ctx.trace = profile.traced(lambda: drivers.run_closed(
            pipe, cfg, mix, seed, count=mix["trace_requests"], first=res.first + res.requests, keep=False))
        ctx.traced_requests = mix["trace_requests"]
    out["ctx"] = ctx
    del pipe
    free()
    picks = sample(seed, sorted(res.outputs), mix["check_requests"])
    rows = []
    for i in picks:
        images, audio = res.outputs[i]
        rows += [dict(row, image=images[r], audio=audio[r]) for r, row in enumerate(request_rows(cfg, mix, seed, i,
                                                                                                   device))]
    out["rows"] = rows
    out["checked"] = f"{len(picks)} of {res.requests} requests, {len(rows)} rows"


def request_rows(cfg, mix, seed, i, device) -> list:
    """The inputs of request ``i``'s rows, as the check takes them: the family's per-row tensors."""
    inp = traffic.closed_inputs(cfg, mix, seed, i, device)
    return [{k: v[r] for k, v in inp.items()} for r in range(mix["batch"])]


def control_rows(cell, seed, device) -> list:
    """The rows a run of the cell would check (one request's), without the program's outputs."""
    return request_rows(cell.cfg, cell.mix, seed, 1, device)
