"""Stage marks in the fused request's graph (``csrc/stage_mark.cu``).

:func:`stage_mark` launches the empty kernel ``adt_stage_mark<k>`` on the
current stream, so a device trace of a replayed request shows boundary ``k``
by name. The kernel reads and writes nothing. On the CPU it
does nothing: there is no device trace to mark.
"""

from __future__ import annotations

import torch

from . import _build

MARKS = 4  # the request's start and the ends of the denoise, the decode and the audio


def stage_mark(k: int, device: torch.device) -> None:
    """Mark boundary ``k`` (0: the request's start; 1: the denoise's end; 2:
    the decode's end; 3: the audio's end) on ``device``'s current stream.
    Never synchronizes, so a CUDA graph can capture it."""
    if device.type != "cuda":
        return
    if not 0 <= k < MARKS:
        raise ValueError(f"stage_mark: boundary {k} is not in 0..{MARKS - 1}")
    dev = device.index if device.index is not None else torch.cuda.current_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"stage_mark: cuda:{dev} is not the current device, cuda:{torch.cuda.current_device()}")
    code = _build.load().on(dev).adt_stage_mark_launch(k, torch._C._cuda_getCurrentRawStream(dev))
    if code:
        _build.check(code, f"stage_mark({k})")
