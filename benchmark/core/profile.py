"""The traced sub-window: ``torch.profiler`` over a few requests or seconds,
reduced to what the per-layer readers and the result line take.

``Trace`` holds the device's operations (kernels, copies, sets: name, start,
duration), the host's, and the window: the span of the harness's own
``bench.window`` annotation, in the profiler's clock. ``busy_s`` is the
union of the device's operations inside the window, so two overlapping
kernels count once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

WINDOW_MARK = "bench.window"


@dataclass
class Op:
    name: str
    start: float  # seconds, the profiler's clock
    dur: float


@dataclass
class Trace:
    device_ops: List[Op] = field(default_factory=list)
    host_ops: List[Op] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.start + o.dur, hi)) for o in self.device_ops)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def top_device_ops(self, n: int = 10) -> list:
        total = {}
        for o in self.device_ops:
            total[o.name] = total.get(o.name, 0.0) + o.dur
        return [[k[:200], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps in the window with no device operation, each named by the innermost host
        operation running at its middle."""
        lo, hi = self.window
        edges, last = [], lo
        for a, b in self.busy_intervals():
            if a > last:
                edges.append((last, a))
            last = max(last, b)
        if hi > last:
            edges.append((last, hi))
        gaps = sorted(edges, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [o for o in self.host_ops if o.start <= mid < o.start + o.dur and o.name != WINDOW_MARK]
            label = min(inside, key=lambda o: o.dur).name if inside else "host: no operation recorded"
            out.append([label[:200], b - a])
        return out


def _fields(e):
    start = e.start_ns() * 1e-9 if hasattr(e, "start_ns") else e.start_us() * 1e-6
    dur = e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") else e.duration_us() * 1e-6
    return e.name(), start, dur


def reduce(prof) -> Trace:
    """The Trace of a finished ``torch.profiler.profile``."""
    import torch

    trace = Trace()
    for e in prof.profiler.kineto_results.events():
        name, start, dur = _fields(e)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kineto mirrors host annotations onto the device's timeline; they are spans, not operations
            if name != WINDOW_MARK and not (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
                trace.device_ops.append(Op(name, start, dur))
        else:
            trace.host_ops.append(Op(name, start, dur))
            # the longest: kineto adds a copy that spans only the device work launched from the marking thread
            if name == WINDOW_MARK and dur > trace.window[1] - trace.window[0]:
                trace.window = (start, start + dur)
    return trace


def traced(fn):
    """``fn()`` under the profiler inside a ``bench.window`` annotation, with the device idle at both ends (a
    closed loop's requests); returns (its result, the Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns() * 1e-9
        with record_function(WINDOW_MARK):
            out = fn()
            torch.cuda.synchronize()
        w1 = time.time_ns() * 1e-9
    trace = reduce(prof)
    _host_window(trace, w0, w1)
    return out, trace


def _host_window(trace: Trace, w0: float, w1: float) -> None:
    """Where the profiler kept no ``bench.window`` span as long as half the host's clock around the traced work
    (seen on the card with the open loop's threads running), the window is the host's clock itself: kineto's
    timestamps and ``time.time_ns`` share the epoch."""
    if trace.window[1] - trace.window[0] < 0.5 * (w1 - w0):
        trace.window = (w0, w1)


class Tracer:
    """The profiler started and stopped by two calls (the open loop's traced tail): ``start()``, then
    ``stop()``; ``trace`` holds the result."""

    def __init__(self):
        self._stack = None
        self.trace = None

    def start(self):
        import contextlib

        from torch.profiler import ProfilerActivity, profile, record_function

        self._stack = contextlib.ExitStack()
        self._prof = self._stack.enter_context(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(record_function(WINDOW_MARK))
        self._w0 = time.time_ns() * 1e-9

    def stop(self):
        w1 = time.time_ns() * 1e-9
        self._stack.close()
        self.trace = reduce(self._prof)
        _host_window(self.trace, self._w0, w1)
