"""The two loops a window runs: a closed loop through the pipeline's ``__call__`` and an open loop through
the batcher's ``submit``. Both time on the host's monotonic clock; neither reads a statistic of the
program's own."""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import named, traffic
from .errors import CellError


# ------------------------------------------------------------------ closed loop

class HostCopy:
    """Copies a request's device outputs to the host on a stream of its own, after the request's event, so
    that the next request, already enqueued, keeps the card busy meanwhile."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def mark(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def fetch(self, tensors, event) -> List[np.ndarray]:
        if self.stream is None:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(event)
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for host, t in zip(hosts, tensors):
                host.copy_(t, non_blocking=True)
        self.stream.synchronize()
        return [h.numpy() for h in hosts]


@dataclass
class ClosedResult:
    first: int  # index of the first request
    requests: int
    rows: int
    window_s: float
    outputs: Dict[int, tuple] = field(default_factory=dict)  # request index -> (uint8 images, int16 audio)


def run_closed(pipe, cfg: dict, mix: dict, seed: int, *, seconds: Optional[float] = None,
               count: Optional[int] = None, first: int = 0, keep: bool = True) -> ClosedResult:
    """Requests back to back, each enqueued before the previous one's outputs are copied to the host, until
    ``seconds`` have passed (then the last one is finished) or ``count`` requests were sent, each request ``i``
    the configuration's family's ``call`` on its ``inputs``. The window runs from the first request's call to the
    last one's outputs on the host."""
    fam = named.family(cfg)
    copier = HostCopy(pipe.device)
    res = ClosedResult(first, 0, 0, 0.0)
    pending = None
    t0 = time.perf_counter()
    i = first
    while True:
        if count is not None and i - first >= count:
            break
        if seconds is not None and i > first and time.perf_counter() - t0 >= seconds:
            break
        outs = fam.call(pipe, fam.inputs(cfg, mix, seed, i, pipe.device), mix)
        ev = copier.mark()
        if pending is not None:
            host = copier.fetch(pending[1], pending[2])
            if keep:
                res.outputs[pending[0]] = tuple(host)
        pending = (i, outs, ev)
        i += 1
    host = copier.fetch(pending[1], pending[2])
    if keep:
        res.outputs[pending[0]] = tuple(host)
    res.window_s = time.perf_counter() - t0
    res.requests = i - first
    res.rows = res.requests * mix["batch"]
    return res


# -------------------------------------------------------------------- open loop

class BatchLog:
    """The harness's own record of the batches the batcher finishes in the window. The batcher keeps only its
    last few in ``stats``, so a thread of the log copies every new entry, counted by ``batches_run``, every
    ``every_s`` seconds, also while the loop's thread waits. :meth:`close` raises
    :class:`CellError` where an entry went before it was copied."""

    def __init__(self, batcher, every_s: float = 0.05):
        self.batcher = batcher
        with batcher._stats_lock:
            self.base = batcher.batches_run
        self.entries: List[dict] = []
        self._lock = threading.Lock()
        self._error = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._watch, args=(every_s,), name="bench-batch-log", daemon=True)
        self._thread.start()

    def _watch(self, every_s: float) -> None:
        while not self._done.wait(every_s):
            try:
                self.pull()
            except CellError:
                return

    def pull(self) -> int:
        """Copies the entries finished since the last pull; returns how many the log holds."""
        b = self.batcher
        with self._lock:
            if self._error is None:
                with b._stats_lock:
                    new = b.batches_run - self.base - len(self.entries)
                    stats = list(b.stats)
                if new > len(stats):
                    self._error = CellError(f"the batcher finished {new} batches since the last look and keeps "
                                            f"{len(stats)}: the harness lost the record of some")
                elif new > 0:
                    self.entries += stats[len(stats) - new:]
            if self._error is not None:
                raise self._error
            return len(self.entries)

    def stop(self) -> None:
        self._done.set()
        self._thread.join()

    def close(self) -> List[dict]:
        """Stops the thread and returns every entry; raises where one was lost."""
        self.stop()
        self.pull()
        return self.entries


@dataclass
class OpenResult:
    due: np.ndarray  # seconds after the window opened
    seeds: list
    late_s: np.ndarray  # how late the generator submitted each request
    latency_s: np.ndarray  # due -> result on the host; a missing request counts its whole wait
    shed: List[bool]
    errors: Dict[int, str]
    results: Dict[int, object]  # request index -> GenerationResult
    window_s: float
    queued_at_close: int  # requests still queued (not yet in a batch) as the window closed
    batches: List[dict] = field(default_factory=list)  # the batcher's entry of each batch, in order (BatchLog)

    @property
    def completed(self) -> int:
        return len(self.results)

    @property
    def failed(self) -> int:
        return len(self.due) - self.completed


def _stamp(done: list, j: int, fut) -> None:
    done[j] = time.monotonic()


def run_open(batcher, mix: dict, seed: int, seconds: float) -> OpenResult:
    """Submit every arrival of the mix at its due time, whatever the system does; then wait for every
    accepted request, ``drain_s`` past the window's close at most."""
    due = traffic.open_arrivals(mix, seed, seconds)
    log = BatchLog(batcher)
    try:
        res = _open_window(batcher, mix, due, traffic.user_seeds(seed, len(due)), seconds)
    finally:
        log.stop()
    res.batches = log.close()
    return res


def traced_tail(batcher, mix: dict, window: OpenResult, tracer) -> Optional[OpenResult]:
    """The traced sub-window of an open loop, after its window: the arrivals of the window's last ``trace_s``
    seconds sent again on their schedule, with ``tracer`` (``start()``, ``stop()``) started before the first
    and stopped once every one is answered and the card is idle. So the profiler starts and stops while no
    thread of the batcher calls into the card, and the window itself runs untraced, as without ``--trace``.
    Returns the tail's result, or None (nothing traced) where the window left the batcher busy."""
    if window.errors or batcher.latency_summary()["queued"]:
        return None
    keep = window.due >= window.due[-1] - mix["trace_s"]
    due = window.due[keep] - window.due[keep][0]
    seeds = [s for s, k in zip(window.seeds, keep) if k]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    tracer.start()
    try:
        res = _open_window(batcher, mix, due, seeds, float(due[-1]))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        tracer.stop()
    return res


def _open_window(batcher, mix, due, seeds, seconds) -> OpenResult:
    from audio_diffusion_torch.serving.batcher import QueueFull

    n = len(due)
    done, futures, shed = [None] * n, [None] * n, [False] * n
    late = np.zeros(n)
    t0 = time.monotonic()
    for j in range(n):
        target = t0 + due[j]
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        late[j] = time.monotonic() - target
        try:
            fut = batcher.submit(seed=seeds[j], steps=mix["steps"], eta=mix["eta"])
        except QueueFull:
            shed[j] = True
            continue
        fut.add_done_callback(functools.partial(_stamp, done, j))
        futures[j] = fut
    close = t0 + seconds
    if close > time.monotonic():
        time.sleep(close - time.monotonic())
    queued = batcher.latency_summary()["queued"]
    deadline = close + mix["drain_s"]
    results, errors = {}, {}
    for j, fut in enumerate(futures):
        if fut is None:
            continue
        try:
            results[j] = fut.result(timeout=max(0.0, deadline - time.monotonic()))
        except Exception as e:  # a batch's error reaches each of its requests; a timeout leaves it missing
            errors[j] = f"{type(e).__name__}: {e}"
            continue
        if done[j] is None:  # the result is out before its callback ran: the time it was read
            done[j] = time.monotonic()
    end = time.monotonic()
    latency = np.array([(done[j] if j in results else end) - (t0 + due[j]) for j in range(n)])
    return OpenResult(due, seeds, late, latency, shed, errors, results, seconds, queued)


def p95(values) -> float:
    """The nearest-rank 95th percentile of all ``values``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, int(np.ceil(0.95 * len(v))) - 1)])
