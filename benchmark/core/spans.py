"""What the readers of the program's own marks, spans and counters share.

- The stage marks: the fused request's graph launches the empty kernels
  ``adt_stage_mark<0..3>`` at the request's start and after the denoise, the
  VAE decode and the mel inversion (``audio_diffusion_torch/ops/stage_mark.py``).
  A stage's reading is the device's busy time (the union of its operations)
  from the end of the mark before it to the start of the mark after it, in
  each traced request; the median over the requests.
- The batcher's ``stats`` entries (``batch``, ``wait_ms``, ``assemble_ms``,
  ``launch_ms``, ``device_ms``), as the harness copied them for the window.
- The batcher's worker spans (``audio_diffusion_torch/utils/profiling.py::spans``,
  stamped by ``time.time_ns``, the clock of the profiler's timestamps),
  recorded while the profiler traced the open loop's tail.

A program without them (an older one) gives every reader nothing to read, and
so does a run on the CPU; inputs that disagree raise :class:`ReadError`.
"""

from __future__ import annotations

import re
import statistics

from .readers import ReadError

MARK = re.compile(r"\badt_stage_mark<(\d)>")
MARKS = 4
WORKER_SPANS = ("adt.serve.hold", "adt.serve.assemble", "adt.serve.launch", "adt.serve.backpressure")


def _overlap(intervals, a: float, b: float) -> float:
    """Seconds of the sorted, disjoint ``intervals`` inside [a, b]."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for lo, hi in intervals if lo < b and hi > a)


def _merge(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def stage_ms(ctx, k: int):
    """ms of the stage between marks ``k`` and ``k + 1``: the median over the traced requests of the device's
    busy time from the end of mark k to the start of mark k + 1. None without a trace or without marks; raises
    unless each mark appears once per traced request, in order."""
    if ctx.trace is None or not getattr(ctx, "traced_requests", 0):
        return None
    lo, hi = ctx.trace.window
    marks = {j: [] for j in range(MARKS)}
    for o in ctx.trace.device_ops:
        m = MARK.search(o.name)
        if m and lo <= o.start < hi:
            marks.setdefault(int(m.group(1)), []).append(o)
    if not any(marks.values()):
        return None
    n = ctx.traced_requests
    counts = {j: len(v) for j, v in sorted(marks.items())}
    if set(counts) != set(range(MARKS)) or any(c != n for c in counts.values()):
        raise ReadError(f"stage marks: the profiler saw {counts} for {n} traced requests")
    rows = [sorted(marks[j], key=lambda o: o.start) for j in range(MARKS)]
    edges = [t for i in range(n) for j in range(MARKS) for t in (rows[j][i].start, rows[j][i].start + rows[j][i].dur)]
    if edges != sorted(edges):
        raise ReadError("stage marks: a request's marks are out of order or overlap another request's")
    busy = ctx.trace.busy_intervals()
    per_request = [_overlap(busy, rows[k][i].start + rows[k][i].dur, rows[k + 1][i].start) for i in range(n)]
    return 1e3 * statistics.median(per_request)


def card_batches(ctx):
    """The window's batcher entries where they carry the device's time (a run on the card of a program that
    records it), else None; raises where the entries disagree with themselves."""
    batches = getattr(ctx, "batches", None)
    if not batches or any("device_ms" not in b for b in batches):
        return None
    on_card = [b["device_ms"] is not None for b in batches]
    if not any(on_card):
        return None
    if not all(on_card):
        raise ReadError(f"{on_card.count(False)} of {len(batches)} batches carry no device time")
    for b in batches:
        if len(b["wait_ms"]) != b["n"]:
            raise ReadError(f"batch {b['batch']}: {len(b['wait_ms'])} waits for {b['n']} rows")
    return batches


def idle_queued_pct(ctx, program_spans, dropped: int):
    """The share of the traced window in which no device operation runs while the batcher's worker is inside
    one of :data:`WORKER_SPANS` (``program_spans``: the program's recorded spans, ns stamps). Raises where the
    buffer let spans go, or where the card ran work in the window and no worker span was recorded."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    if dropped:
        raise ReadError(f"the program's span buffer let {dropped} spans go")
    lo, hi = ctx.trace.window
    worker = _merge((max(s.t0_ns * 1e-9, lo), min(s.t1_ns * 1e-9, hi)) for s in program_spans
                    if s.name in WORKER_SPANS)
    busy = ctx.trace.busy_intervals()
    if not worker:
        if busy:
            raise ReadError("the tail ran work on the card and the batcher's worker recorded no span")
        return None
    idle, last = [], lo
    for a, b in busy:
        if a > last:
            idle.append((last, a))
        last = max(last, b)
    if hi > last:
        idle.append((last, hi))
    return 100.0 * sum(_overlap(worker, a, b) for a, b in idle) / ctx.trace.window_s
