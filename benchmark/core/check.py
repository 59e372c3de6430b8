"""What decides ``correct``: the program's outputs from the window judged against the plain reference.

Generation and serving are judged the same way, on a sample of the window's
requests drawn from the seed, once the window has closed and the program's
state is freed:

- ``spec_mae``: the spectrograms. The reference of the configuration's model
  family (``families/<family>.py::reference_images``) runs the whole request
  from the same inputs in float32 with TF32 off (in ``audio_diffusion``: 50
  DDIM steps of its UNet, its VAE decode, uint8). The number is the worst
  sampled row's mean absolute difference from the program's uint8
  spectrogram, in uint8 levels.
- ``audio_rel``: the audio. The reference inverts the PROGRAM's spectrogram
  (NNLS, Griffin-Lim from the same initial phase, int16 PCM), so that this
  stage is judged alone, the stage before it being judged by ``spec_mae``.
  The number is the worst sampled row's RMS difference of the int16 PCM over
  the reference's RMS.

Each number's limit is in ``benchmark/limits/<workload>.json``, with the
readings it was set from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import pipeline as ref
from . import named

NUMBERS = ("spec_mae", "audio_rel")


def _rows_metrics(prog_img, prog_pcm, ref_img, ref_pcm) -> dict:
    spec = (prog_img.float() - ref_img.float()).abs().mean(dim=(1, 2))
    diff = (prog_pcm.float() - ref_pcm.float()).pow(2).mean(dim=1).sqrt()
    rel = diff / ref_pcm.float().pow(2).mean(dim=1).sqrt().clamp(min=1.0)
    return {"spec_mae": spec.cpu().tolist(), "audio_rel": rel.cpu().tolist()}


@torch.no_grad()
def judge_rows(cfg: dict, seed: int, steps: int, rows: list, device, precision: str = "float32",
               rows_per_block: int = 8) -> dict:
    """Per-row numbers of ``rows``: dicts with the program's ``image`` (H, W) uint8 and ``audio`` int16 as
    numpy, the request's ``gl_phase`` and the rest of its per-row inputs (the family's: ``noise`` and, for a
    conditional configuration, ``encoding``) as tensors. The reference's spectrograms come from the
    configuration's family (``reference_images``). ``precision`` "fp8" puts the reference in the program's place
    (the control): its float8 spectrograms, and their audio from a bfloat16 mel inversion (the step below the
    program's float32 audio stage), are judged instead of the rows' outputs; "fp8-unet" does so with the UNet
    alone in float8 (a reading of what the UNet's share of the control is, not a control)."""
    fam = named.family(cfg)
    with ref.float32_exact():
        ref_img = fam.reference_images(cfg, seed, steps, rows, device, "float32", rows_per_block)
        phase = torch.stack([r["gl_phase"] for r in rows]).to(device)
        if precision == "float32":
            prog_img = torch.as_tensor(np.stack([r["image"] for r in rows])).to(device)
            prog_pcm = torch.as_tensor(np.stack([r["audio"] for r in rows])).to(device)
        else:
            prog_img = fam.reference_images(cfg, seed, steps, rows, device, precision, rows_per_block)

        def audio(p):
            return torch.cat([ref.images_to_pcm16(prog_img[i:i + rows_per_block], phase[i:i + rows_per_block],
                                                  cfg["mel"], p) for i in range(0, len(rows), rows_per_block)])

        ref_pcm = audio("float32")
        if precision != "float32":
            prog_pcm = audio("bfloat16" if precision == "fp8" else "float32")
        return _rows_metrics(prog_img, prog_pcm, ref_img, ref_pcm)


def worst(per_row: dict) -> dict:
    return {k: float(max(v)) for k, v in per_row.items()}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    shown = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    return all(numbers[k] <= limits[k]["limit"] for k in limits), shown
