"""Dynamic request batching over the pipeline (port of ``audio_diffusion_tpu/serving/batcher.py``).

* **Batch tiers.** Requests pad up to a fixed tier (1, 2, 4, ... ``max_batch``;
  for a sharded pipeline, ``pipe.shard(mesh)``, multiples of the mesh's
  data-axis size), so the device only ever sees ``len(tiers)`` batch shapes, each warmed at
  startup by :meth:`DynamicBatcher.warmup` (kernel libraries, cuDNN
  algorithm choice, the caching allocator, and the capture of each fused
  program's CUDA graph). The default "snap" policy
  dispatches the largest tier <= queue depth and leaves the rest queued, so
  at load every device row is a real request.
* **Per-request determinism.** A request's initial noise comes from ITS seed
  on the host (numpy PCG64, bitwise the JAX package's), and the variance noise
  of stochastic steps (DDPM, eta > 0) from a per-row ``torch.Generator``
  seeded with it (schedulers/common.py::step_noises). A row's spectrogram is
  therefore bitwise the same for any co-batch and, at eta 0, in any tier, as
  in the JAX package, in bf16 and in f32. On a CUDA device that needs two
  things. cuDNN is off while a batch runs: it picks other convolution
  kernels per batch shape, which round a row differently (chip_smoke.py's
  ``[tier]`` names the calls; ``cudnn.deterministic`` does not help), and 50
  denoise steps grow that rounding to whole uint8 levels; PyTorch's own
  convolutions compute each row alone. The switch is one process-wide window
  (:func:`..utils.batch_invariant.window`, entered by :meth:`DynamicBatcher._call_pipe`):
  while any batcher's batch runs, every other thread of the process sees
  cuDNN off too, and the flag comes back once the last batch of all ends.
  And f32 attention runs in fixed blocks of rows
  (:func:`..models.unet2d.in_row_blocks`), so cuBLAS sees one GEMM shape per
  block whatever the tier. PERF.md records what both cost. Griffin-Lim's
  initial phase is drawn batch-shaped, so audio agrees across compositions
  to Griffin-Lim convergence, not bitwise.
* **One worker owns the device; copies overlap compute.** Requests enqueue
  holding only their seed and settings; one worker drains a settings group
  and makes ONE pipeline call per batch. On a CUDA device the outputs are
  copied to pinned host buffers on a side stream, ordered after an event
  recorded at the end of the batch, so the worker can launch the next
  batch at once and the copy runs beside it; a plain ``.cpu()`` on the
  default stream would queue behind that next batch. The device tensors are
  ``record_stream``-ed so the caching allocator does not hand their memory
  to the next batch before the copy is done. A finisher thread waits for
  the copy and resolves the futures. On a CPU device the outputs already
  are on the host.
* **Admission control.** ``submit`` sheds over-capacity requests with
  :class:`QueueFull` (global and per-group caps, throughput-based
  ``retry_after_s``); the HTTP front-end maps it to 429 + ``Retry-After``.
* **What it records.** Each finished batch appends one entry to ``stats``:
  its sequence number ``batch`` (a served request is (batch, row)), ``n``,
  ``tier``, ``steps``; ``wait_ms``, one per row, from ``submit`` to the
  worker taking the batch; ``assemble_ms``, from there to the pipeline call;
  ``launch_ms``, from the pipeline call to handing the batch to the finisher
  (a blocked hand-over left out); ``run_s``, from the pipeline call to the
  results on the host (behind the batches already launched, the copy and
  the delivery included); ``device_ms``, CUDA events on the pipeline's
  stream around the pipeline call (None on the CPU); ``copy_ms``. A row's
  ``wait_ms + assemble_ms + run_s`` is its submit-to-result latency. While
  a profiler runs, the worker also records spans (:func:`..utils.profiling.span`):
  ``adt.serve.hold`` (a head request found, companions awaited, the batch
  taken), ``adt.serve.assemble``, ``adt.serve.launch`` (the pipeline call
  and the copy's start) and ``adt.serve.backpressure`` (the hand-over to
  the finisher blocked), each with its ``batch``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import batch_invariant, profiling


@dataclass
class GenerationResult:
    """One request's outputs, already on host."""

    image: np.ndarray  # (H, W) uint8 mel spectrogram
    audio: np.ndarray  # float32 waveform, or int16 when the batcher runs pcm16
    sample_rate: int


class QueueFull(RuntimeError):
    """Raised by :meth:`DynamicBatcher.submit` when admission control sheds
    the request. ``retry_after_s`` is the throughput-based estimate of when
    capacity frees up; the HTTP front-end forwards it as ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclass
class _Pending:
    seed: int  # the initial noise derives from this when the batch is assembled
    encoding: Optional[np.ndarray]  # (seq, dim) or None
    audio: Optional[np.ndarray]  # (samples,) input clip for audio-to-audio
    future: Future
    enqueued: float


def _noise_for_seed(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """Deterministic per-request initial noise, independent of batch shape."""
    return np.random.default_rng(seed).standard_normal((h, w, c)).astype(np.float32)


def copy_to_host_async(tensors: Sequence[torch.Tensor], stream: Optional[torch.cuda.Stream]):
    """Start copying ``tensors`` to the host without waiting for them.

    CUDA tensors: an event recorded now on the current stream orders the
    copies after every kernel queued so far there; the copies run on
    ``stream`` into pinned buffers, and each device tensor is
    ``record_stream``-ed on it so its memory is not reused before the copy
    ends. Returns ``(host tensors, (start, done) timing events)``; read the
    host tensors only after ``done.synchronize()``. CPU tensors come back as
    they are, with no events."""
    if tensors[0].device.type != "cuda":
        return list(tensors), None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensors[0].device))
    stream.wait_event(ready)
    start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # inference mode: the pipeline's outputs are inference tensors, and
    # record_stream counts as writing to them
    with torch.inference_mode(), torch.cuda.stream(stream):
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        start.record(stream)  # after the host allocations, so start..done times the copies
        for host, t in zip(hosts, tensors):
            host.copy_(t, non_blocking=True)
            t.record_stream(stream)
        done.record(stream)
    return hosts, (start, done)


class DynamicBatcher:
    """Groups concurrent generation requests into padded fixed-tier batches.

    Args:
        pipe: an ``AudioDiffusionPipeline`` (or a compatible callable object).
        max_batch: largest batch tier; tiers are the powers of two up to it
            (times the data-axis size of a sharded pipeline).
        max_wait_ms: how long the worker holds the FIRST request of a batch
            open for companions.
        steps / eta: settings shared by all requests unless a request
            overrides them; distinct settings batch separately, never together.
        pcm16: quantize audio to int16 on the device (half the copy).
        batch_policy: "snap" (largest tier <= queue depth) or "pad" (take all
            queued, pad to the next tier).
        allowed_steps / allowed_etas / allowed_start_steps: the settings a
            request may ask for besides the defaults; each is warmed up.
        max_queue / max_group_queue: admission caps (default 8 full tiers,
            and the global cap per group).
    """

    def __init__(
        self,
        pipe,
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        steps: Optional[int] = None,
        eta: float = 0.0,
        pcm16: bool = False,
        batch_policy: str = "snap",
        allowed_steps: Optional[Sequence[int]] = None,
        allowed_etas: Optional[Sequence[float]] = None,
        allowed_start_steps: Optional[Sequence[int]] = None,
        conditional_seq: int = 1,
        max_queue: Optional[int] = None,
        max_group_queue: Optional[int] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pipe = pipe
        # A sharded pipeline splits every batch along 'data': each tier is a
        # multiple of the data-axis size.
        mesh = getattr(pipe, "mesh", None)
        base = dict(mesh.shape).get("data", 1) if mesh is not None else 1
        if max_batch % base != 0:
            raise ValueError(f"max_batch ({max_batch}) must be a multiple of the mesh's data-axis size ({base}) — "
                             "sharded batches split along 'data'.")
        self.tiers = tuple(base * 2**i for i in range((max_batch // base).bit_length()) if base * 2**i <= max_batch)
        if self.tiers[-1] != max_batch:
            self.tiers = self.tiers + (max_batch,)
        if batch_policy not in ("snap", "pad"):
            raise ValueError(f"batch_policy must be 'snap' or 'pad', got {batch_policy!r}")
        self.batch_policy = batch_policy
        self.max_wait_s = max_wait_ms / 1000.0
        # The default resolved concretely, so {"steps": 50} and steps omitted
        # land in the same group when 50 is the scheduler's default.
        self.default_steps = steps if steps is not None else pipe.get_default_steps()
        self.default_eta = float(eta)
        # Only declared (warmed) settings are accepted; anything else fails at
        # submit() with the fix spelled out.
        self.allowed_steps = {self.default_steps} | {int(s) for s in (allowed_steps or ())}
        self.allowed_etas = {self.default_eta} | {float(e) for e in (allowed_etas or ())}
        self.allowed_start_steps = {int(s) for s in (allowed_start_steps or ())}
        self.conditional_seq = conditional_seq
        self.pcm16 = pcm16
        self.max_queue = int(max_queue) if max_queue is not None else 8 * self.tiers[-1]
        self.max_group_queue = int(max_group_queue) if max_group_queue is not None else self.max_queue
        if self.max_queue < 1 or self.max_group_queue < 1:
            raise ValueError("max_queue / max_group_queue must be >= 1")
        self.device = torch.device(getattr(pipe, "device", "cpu"))
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.requests_shed = 0
        self._groups: dict = {}  # settings key -> deque[_Pending]
        self._cond = threading.Condition()
        self._closed = False
        self.batches_run = 0
        self.requests_served = 0
        self.stats = deque(maxlen=256)  # per batch: the module docstring's "What it records"
        self._taken = 0  # the next batch's sequence number
        self._latencies = deque(maxlen=1024)  # per request: submit -> result, s
        self._stats_lock = threading.Lock()  # healthz readers vs the finisher
        # maxsize=2 bounds how many undelivered batch outputs sit on the device.
        self._finish_q: queue.Queue = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, name="adt-batcher", daemon=True)
        self._worker.start()
        self._finisher = threading.Thread(target=self._finish_loop, name="adt-finisher", daemon=True)
        self._finisher.start()

    # ------------------------------------------------------------- public API

    def submit(
        self,
        seed: int = 0,
        steps: Optional[int] = None,
        eta: Optional[float] = None,
        encoding: Optional[np.ndarray] = None,
        audio: Optional[np.ndarray] = None,
        start_step: int = 0,
    ) -> Future:
        """Enqueue one generation; returns a Future of :class:`GenerationResult`.
        Validation happens here, per request, so a bad request fails alone."""
        seed = int(seed)
        if not 0 <= seed < 2**63:
            raise ValueError(f"seed must be in [0, 2**63), got {seed}")
        steps = int(steps) if steps is not None else self.default_steps
        if steps not in self.allowed_steps:
            raise ValueError(
                f"steps={steps} is not served (allowed: {sorted(self.allowed_steps)}). "
                "Declare other step counts via allowed_steps (CLI: --allow_steps) so they are warmed up."
            )
        eta = float(eta) if eta is not None else self.default_eta
        if eta not in self.allowed_etas:
            raise ValueError(
                f"eta={eta} is not served (allowed: {sorted(self.allowed_etas)}); "
                "declare it via allowed_etas (CLI: --allow_etas)."
            )
        cross_dim = self.pipe.unet.config.cross_attention_dim
        if encoding is not None:
            if cross_dim is None:
                raise ValueError("this model is unconditional — drop encoding=")
            encoding = np.asarray(encoding, dtype=np.float32)
            if encoding.ndim == 1:
                encoding = encoding[None, :]  # (dim,) -> length-1 sequence
            if encoding.ndim != 2 or encoding.shape[-1] != cross_dim:
                raise ValueError(
                    f"encoding must be (seq, cross_attention_dim={cross_dim}), "
                    f"got shape {encoding.shape}"
                )
            if encoding.shape[0] != self.conditional_seq:
                raise ValueError(
                    f"encoding seq length {encoding.shape[0]} is not served "
                    f"(this server compiles seq={self.conditional_seq}; "
                    "configure conditional_seq to serve longer sequences)."
                )
        elif cross_dim is not None:
            raise ValueError("this model is conditional — an encoding= is required")
        start_step = int(start_step)
        if audio is not None:
            if start_step not in self.allowed_start_steps:
                raise ValueError(
                    f"audio-to-audio start_step={start_step} is not served "
                    f"(allowed: {sorted(self.allowed_start_steps) or 'none'}); "
                    "declare served values via allowed_start_steps "
                    "(CLI: --allow_start_steps) so they are warmed up."
                )
            if not 0 < start_step < steps:
                raise ValueError(
                    f"start_step must be in (0, steps={steps}) for audio-to-audio, "
                    f"got {start_step}"
                )
            audio = np.asarray(audio, dtype=np.float32).reshape(-1)
            full = self.pipe.mel.x_res * self.pipe.mel.hop_length
            if len(audio) > full:
                audio = audio[:full]  # one slice per request
        elif start_step != 0:
            raise ValueError("start_step without audio= has nothing to re-noise — "
                             "pass the input clip")
        key = (steps, eta, None if encoding is None else encoding.shape, start_step, audio is not None)
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            total = sum(len(dq) for dq in self._groups.values())
            group_len = len(self._groups.get(key, ()))
            if total >= self.max_queue or group_len >= self.max_group_queue:
                self.requests_shed += 1
                which = "queue" if total >= self.max_queue else f"settings-group {key} queue"
                raise QueueFull(
                    f"server over capacity: {which} full ({total}/{self.max_queue} queued); retry later",
                    retry_after_s=self._retry_after(total),
                )
            self._groups.setdefault(key, deque()).append(_Pending(seed, encoding, audio, fut, time.monotonic()))
            self._cond.notify()
        return fut

    def _retry_after(self, queued: int) -> float:
        """Queued work over recent throughput, clamped to [1, 60] s; 60 s with no stats yet."""
        with self._stats_lock:
            stats = list(self.stats)
        if stats:
            total_run = sum(s["run_s"] for s in stats) or 1e-3
            rate = sum(s["n"] for s in stats) / total_run
            est = queued / max(rate, 1e-3)
        else:
            est = 60.0
        return float(min(max(est, 1.0), 60.0))

    def _step_generators(self, seeds: Sequence[int]) -> list:
        return [torch.Generator(device=self.device).manual_seed(s) for s in seeds]

    def _call_pipe(self, **kwargs):
        """One pipeline call; on a CUDA device inside the process-wide
        :func:`..utils.batch_invariant.window` (the module docstring's
        per-request determinism). Every kernel of the call is chosen before it
        returns, so the window closes at once; the cuDNN flag is part of a fused
        program's signature, so a batch replays a graph captured in the window."""
        if self.device.type != "cuda":
            return self.pipe(**kwargs)
        with batch_invariant.window():
            return self.pipe(**kwargs)

    def warmup(self) -> None:
        """Run every (tier, steps, eta, start_step) the server accepts once, up
        front, with the same arguments a live batch passes (per-row step
        generators included), so live traffic meets no first-call cost: on
        the pipeline's fused path this captures every program a live batch
        replays, and none is captured inside the serving window."""
        h, w = self.pipe.sample_hw
        c = self.pipe.unet.config.in_channels
        cross_dim = self.pipe.unet.config.cross_attention_dim
        full = self.pipe.mel.x_res * self.pipe.mel.hop_length
        for tier in self.tiers:
            noise = np.zeros((tier, h, w, c), np.float32)
            enc = None
            if cross_dim is not None:
                enc = np.zeros((tier, self.conditional_seq, cross_dim), np.float32)
            for steps in sorted(self.allowed_steps):
                for eta in sorted(self.allowed_etas):
                    for start_step in [0] + sorted(s for s in self.allowed_start_steps if 0 < s < steps):
                        self._call_pipe(
                            noise=noise, encoding=enc, steps=steps, eta=eta, start_step=start_step,
                            step_generator=self._step_generators([0] * tier),
                            raw_audio=np.zeros((tier, full), np.float32) if start_step else None,
                            return_arrays=True, pcm16=self.pcm16,
                        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stop the workers after draining already-queued requests."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()
        self._finish_q.put(None)
        self._finisher.join()

    # ---------------------------------------------------------------- worker

    def _tier_for(self, n: int) -> int:
        for t in self.tiers:
            if t >= n:
                return t
        return self.tiers[-1]

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closed and not any(self._groups.values()):
                    self._cond.wait()
                if not any(self._groups.values()):
                    return  # closed and drained
                seq = self._taken
                self._taken += 1
                with profiling.span("adt.serve.hold", batch=seq):
                    # Serve the group whose head request has waited longest.
                    key = min((k for k, dq in self._groups.items() if dq),
                              key=lambda k: self._groups[k][0].enqueued)
                    dq = self._groups[key]
                    deadline = dq[0].enqueued + self.max_wait_s
                    while (
                        not self._closed
                        and len(dq) < self.tiers[-1]
                        and (remaining := deadline - time.monotonic()) > 0
                    ):
                        self._cond.wait(timeout=remaining)
                    if self.batch_policy == "snap" and len(dq) >= self.tiers[0]:
                        take = max(t for t in self.tiers if t <= len(dq))
                    else:
                        take = min(len(dq), self.tiers[-1])
                    batch = [dq.popleft() for _ in range(take)]
                    t_take = time.monotonic()
                    if not dq:
                        del self._groups[key]
            # Mark running (and drop requests cancelled while queued) BEFORE
            # the device call: a set_result on a cancelled future would raise
            # mid-fan-out and corrupt co-batched results.
            batch = [p for p in batch if p.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                self._run_batch(key, batch, seq, t_take)
            except Exception as e:  # propagate to every caller, keep serving
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _run_batch(self, key: tuple, batch: list, seq: int, t_take: float) -> None:
        steps, eta, enc_shape, start_step, has_audio = key
        h, w = self.pipe.sample_hw
        c = self.pipe.unet.config.in_channels
        tier = self._tier_for(len(batch))

        with profiling.span("adt.serve.assemble", batch=seq):
            noise = np.zeros((tier, h, w, c), np.float32)
            for i, p in enumerate(batch):
                noise[i] = _noise_for_seed(p.seed, h, w, c)
            encoding = None
            if enc_shape is not None:
                encoding = np.zeros((tier,) + enc_shape, np.float32)
                for i, p in enumerate(batch):
                    encoding[i] = p.encoding
            raw_audio = None
            if has_audio:
                # (tier, slice): each request styles its own clip; padding rows are silence.
                full = self.pipe.mel.x_res * self.pipe.mel.hop_length
                raw_audio = np.zeros((tier, full), np.float32)
                for i, p in enumerate(batch):
                    raw_audio[i, : len(p.audio)] = p.audio
            # Per-row step generators seeded from each request's seed: a
            # request's stochastic samples are the same alone or co-batched.
            # Padding rows take seed 0; their outputs are dropped.
            step_generator = self._step_generators([p.seed for p in batch] + [0] * (tier - len(batch)))

        with profiling.span("adt.serve.launch", batch=seq):
            t_run = time.monotonic()
            on_card = None
            if self._copy_stream is not None:  # on a CUDA device
                on_card = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                on_card[0].record(torch.cuda.current_stream(self.device))
            raw_dev, audios_dev = self._call_pipe(
                noise=noise,
                encoding=encoding,
                raw_audio=raw_audio,
                start_step=start_step,
                steps=steps,
                eta=eta,
                step_generator=step_generator,
                return_arrays=True,
                pcm16=self.pcm16,
            )
            if on_card is not None:
                on_card[1].record(torch.cuda.current_stream(self.device))
            hosts, events = copy_to_host_async((raw_dev, audios_dev), self._copy_stream)
        t_hand = time.monotonic()
        times = {"batch": seq, "wait_ms": [round(1e3 * (t_take - p.enqueued), 3) for p in batch],
                 "assemble_ms": round(1e3 * (t_run - t_take), 3), "launch_ms": round(1e3 * (t_hand - t_run), 3)}
        item = (batch, tier, steps - start_step, hosts, events, t_run, times, on_card)
        try:
            self._finish_q.put_nowait(item)
        except queue.Full:
            with profiling.span("adt.serve.backpressure", batch=seq):
                self._finish_q.put(item)

    # -------------------------------------------------------------- finisher

    def _finish_loop(self) -> None:
        while True:
            item = self._finish_q.get()
            if item is None:
                return
            batch, tier, denoise_steps, hosts, events, t_run, times, on_card = item
            try:
                copy_ms = device_ms = None
                if events is not None:
                    events[1].synchronize()  # the copy waited for the pipeline's stream past on_card[1]
                    copy_ms = events[0].elapsed_time(events[1])
                    if on_card is not None:
                        device_ms = on_card[0].elapsed_time(on_card[1])
                raw, audios = (t.numpy() for t in hosts)
            except Exception as e:
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            now = time.monotonic()
            with self._stats_lock:
                self.batches_run += 1
                self.requests_served += len(batch)
                self.stats.append({"n": len(batch), "tier": tier, "steps": denoise_steps,
                                   "run_s": round(now - t_run, 4), "copy_ms": copy_ms, **times,
                                   "device_ms": device_ms})
                self._latencies.extend(round(now - p.enqueued, 4) for p in batch)
            sr = self.pipe.mel.get_sample_rate()
            for i, p in enumerate(batch):
                p.future.set_result(GenerationResult(raw[i], audios[i], sr))

    def latency_summary(self) -> dict:
        """p50/p95 per-request submit-to-result latency, mean occupancy, and
        the device time of the finisher's copies over recent batches."""
        with self._stats_lock:
            stats = list(self.stats)
            lats = sorted(self._latencies)
        with self._cond:
            queued = sum(len(dq) for dq in self._groups.values())
        if not stats or not lats:
            return {"queued": queued, "requests_shed": self.requests_shed}
        out = {
            "queued": queued,
            "requests_shed": self.requests_shed,
            "recent_batches": len(stats),
            "mean_batch": round(sum(s["n"] for s in stats) / len(stats), 2),
            # real rows / dispatched device rows: (1 - fill) went to padding
            "fill": round(sum(s["n"] for s in stats) / max(1, sum(s["tier"] for s in stats)), 3),
            "p50_latency_s": lats[len(lats) // 2],
            "p95_latency_s": lats[min(len(lats) - 1, int(len(lats) * 0.95))],
            "mean_run_s": round(sum(s["run_s"] for s in stats) / len(stats), 4),
        }
        copies = [s["copy_ms"] for s in stats if s["copy_ms"] is not None]
        if copies:
            out["mean_copy_ms"] = round(sum(copies) / len(copies), 4)
        return out
