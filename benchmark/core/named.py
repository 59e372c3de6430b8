"""The files a cell is made of that hold code, found by name: a configuration's model family
(``benchmark/families/<family>.py``), a traffic mix's mode (``benchmark/modes/<mode>.py``), an open loop's arrival
process (``benchmark/arrivals/<arrivals>.py``) and a per-layer metric's reader
(``benchmark/layer_metrics/<metric>.py``). A cell of a new kind adds such a file beside the others and edits none
of them."""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
DEFAULT_FAMILY = "audio_diffusion"


def load(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, executed once per process."""
    if not NAME.match(name):
        raise ValueError(f"{kind}: {name!r} is not a name")
    key = f"benchmark_{kind}__{name.encode().hex()}"  # one module per file, whatever its name
    if key not in sys.modules:
        path = BASE / kind / f"{name}.py"
        if not path.exists():
            raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def family(cfg: dict):
    """The model family of the configuration ``cfg``: ``benchmark/families/<cfg["family"]>.py``, or
    ``audio_diffusion`` where the configuration names none. Everything the harness knows of a model is there:

    - ``program(cfg, seed, device)``: the program's pipeline with the seed's weights;
    - ``inputs(cfg, mix, seed, i, device)``: closed-loop request ``i``'s per-row tensors, batch first, drawn on the
      device from ``traffic.request_generator(device, seed, i)``: always ``noise`` and ``gl_phase``, and whatever
      else the family's pipeline takes;
    - ``call(pipe, inputs, mix)``: one request; its device outputs, (B, H, W) uint8 spectrograms and (B, L) int16
      audio;
    - ``reference_images(cfg, seed, steps, rows, device, precision="float32", rows_per_block=8)``: the (B, H, W)
      uint8 spectrograms of the plain reference (float32, TF32 off) for the rows' inputs, in blocks of rows; with
      ``precision`` "fp8", the control (every product's operands in float8 e4m3), "fp8-unet" the control's
      denoiser alone; the harness judges the audio itself (``core/check.py``);
    - ``flops(cfg, mix)``: {"denoise", "vae_decode", ..., "total"} FLOPs of one request;
    - ``kernel_calls(kernel, cfg, mix)``: (calls per forward, least seconds per forward, forwards per request) of
      one of ``counts/kernels.py``'s kernels;
    - ``tiny(cfg)``: the configuration cut to a CPU test's size;
    - optionally ``served_inputs(cfg, user_seed)``: a served request's per-row tensors other than ``gl_phase``,
      from the user's seed as the batcher draws them; a family without it has no open-loop cell.
    """
    return load("families", cfg.get("family", DEFAULT_FAMILY))
