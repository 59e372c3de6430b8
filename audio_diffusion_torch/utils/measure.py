"""What the measurement programs share (``python -m audio_diffusion_torch.bench``,
``scripts.stage_ledger``, ``scripts.mfu`` and ``scripts.bench_serving``): the
device a measurement ran on, the timers, and the one JSON line each prints.

Every line names its device (:func:`device_block`): on a CUDA device the
card's name (``torch.cuda.get_device_name``), its power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reads it,
and the number of cards; on the CPU the block says ``cpu``. A program asked
for ``cuda`` on a machine without a card raises (:func:`resolve_device`): no
measurement falls back to the CPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from typing import Callable, List

import torch


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; ``cuda`` with an index (the current card).
    Raises when a CUDA device is asked for and torch sees no card."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} asked for, but torch.cuda.is_available() is False: this "
                               "measurement needs an NVIDIA GPU (pass --device cpu to run on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"device {name!r}: expected cuda, cuda:N or cpu")
    return device


def device_block(device: torch.device) -> dict:
    """The device a measurement ran on, for its JSON line. On a CUDA device
    ``nvidia-smi`` must answer: a measurement without its card's power limit
    is not reported."""
    if device.type == "cpu":
        return {"platform": "cpu", "name": "cpu", "power_limit_w": None, "count": 0}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    line = lines[device.index if device.index < len(lines) else 0].strip()
    limit = line.rsplit(",", 1)[1].strip()  # "700.00 W", or "[N/A]" where the card reports none
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit() else None,
            "nvidia_smi": line, "count": torch.cuda.device_count()}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_ms(fn: Callable[[], object], reps: int, device: torch.device) -> List[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` after one untimed
    call: on a CUDA device device time, by CUDA events recorded around each
    call on the current stream; on the CPU the host clock around each call."""
    fn()
    if device.type == "cuda":
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        synchronize(device)
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        synchronize(device)
        return [start.elapsed_time(end) for start, end in pairs]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def median(values) -> float:
    return float(statistics.median(values))


def emit(line: dict) -> dict:
    """Print ``line`` as the program's one JSON line and return it."""
    print(json.dumps(line), flush=True)
    return line
