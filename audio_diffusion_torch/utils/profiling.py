"""Profiling / tracing hooks (port of ``audio_diffusion_tpu/utils/profiling.py``).

``span`` marks a region of the program (the batcher's worker, for one) in an
in-memory buffer, only while a ``torch.profiler`` runs in the process;
``spans`` returns what was recorded. ``trace`` wraps a region in a
``torch.profiler`` trace (host and, on a CUDA device, device activity) and
writes it as a Chrome trace, viewable in Perfetto, with the program's spans
beside the profiler's own rows.

Why a buffer of its own: a ``record_function`` span opened on a thread other
than the one that started the profiler does not reach the profiler's trace,
and the batcher's threads are such threads. The module flag
``torch.autograd.profiler._is_profiler_enabled`` is process-wide (the
thread-local ``torch._C._autograd._profiler_enabled()`` reads False on the
other threads), so a span checks it and does nothing more while no profiler
runs. Stamps come from ``time.time_ns()``, the clock kineto's timestamps share,
so the spans line up with the device's operations. Nothing here starts, stops
or configures a profiler, and nothing touches the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_LIMIT = 65536  # spans kept; the oldest go first


class Span(NamedTuple):
    name: str
    thread: str  # the recording thread's name
    t0_ns: int  # time.time_ns()
    t1_ns: int
    ids: dict  # what the span belongs to, e.g. {"batch": 7}


_spans: deque = deque(maxlen=SPAN_LIMIT)
_lock = threading.Lock()
_dropped = 0
_OFF = contextlib.nullcontext()  # what a span is while no profiler runs


class _On:
    __slots__ = ("name", "ids", "t0")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        rec = Span(self.name, threading.current_thread().name, self.t0, time.time_ns(), self.ids)
        with _lock:
            if len(_spans) == SPAN_LIMIT:
                _dropped += 1
            _spans.append(rec)
        return False


def span(name: str, **ids):
    """A context manager that records ``(name, thread name, t0_ns, t1_ns, ids)``
    when a profiler runs in the process as it is entered, and nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, ids)


def spans() -> list:
    """A copy of the recorded spans (:class:`Span`), oldest first."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """How many spans the buffer has let go, since the process started, to keep :data:`SPAN_LIMIT`."""
    return _dropped


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region into ``log_dir/trace.json``
    when ``log_dir`` is set; a no-op otherwise. The program's spans recorded
    during the region are written into the same file, on its time base, one
    row per recording thread (category ``adt_span``)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    t0, lost = time.time_ns(), dropped()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    t1 = time.time_ns()
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in spans() if t0 <= s.t0_ns and s.t1_ns <= t1], dropped() - lost)


def _write_spans(path: str, recorded: list, lost: int) -> None:
    with open(path) as fh:
        doc = json.load(fh)
    base = doc.get("baseTimeNanoseconds", 0)  # ts = (ns - base) / 1000, in µs
    pid = os.getpid()
    threads = {}
    events = doc["traceEvents"]
    for s in recorded:
        tid = threads.setdefault(s.thread, 1_000_000_000 + len(threads))  # clear of the OS thread ids
        events.append({"ph": "X", "cat": "adt_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3, "args": dict(s.ids)})
    for thread, tid in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"{thread} (spans)"}})
    if lost:
        doc["adt_spans_dropped"] = lost
    with open(path, "w") as fh:
        json.dump(doc, fh)
