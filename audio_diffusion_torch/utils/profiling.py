"""Profiling / tracing hooks (port of ``audio_diffusion_tpu/utils/profiling.py``).

``trace`` wraps a region in a ``torch.profiler`` trace (host and, on a CUDA
device, device activity) and writes it as a Chrome trace, viewable in
Perfetto; ``StepTimer`` gives cheap per-step wall-time stats without a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region into ``log_dir/trace.json``
    when ``log_dir`` is set; a no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling wall-time-per-step tracker (host-side; call after a blocking op)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def rate(self, items_per_step: int = 1) -> float:
        m = self.mean
        return items_per_step / m if m > 0 else 0.0
