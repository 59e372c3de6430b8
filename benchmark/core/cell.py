"""One run of one cell: set-up, the measured window, the traced sub-window and per-layer readers
(``--trace 1``), the check against the reference, and the result line.

Everything a cell is made of is found by name: the workload in
``BENCHMARK.json``, its configuration in ``benchmark/configs/<config>.json``
and the configuration's model family in ``benchmark/families/<family>.py``
(``core/named.py::family``: the program, its inputs and one request's call,
the reference, the counts), its traffic mix in
``benchmark/traffic/<traffic>.json``, the loop that drives the mix in
``benchmark/modes/<mode>.py`` (the mix's ``mode``: a module with
``run(cell, seed, seconds, trace, device, t_start, out)``, which fills ``out``,
and ``control_rows(cell, seed, device)``), its limits in
``benchmark/limits/<workload>.json`` and each per-layer metric's reader in
``benchmark/layer_metrics/<metric>.py`` (a module with ``read(ctx)``, which
returns a number or None when it finds nothing to read).
"""

from __future__ import annotations

import gc
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import check, named
from .errors import CellError
from .weights import derive_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_diffusion_tpu")
SAMPLE_TAG = 103


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names. The tests hand some of the parts in
    (``manifest``, ``cfg``, ``mix``, ``limits``) in place of the files."""

    def __init__(self, root: Path, name: str, manifest=None, cfg=None, mix=None, limits=None):
        self.root = Path(root)
        self.manifest = manifest or load_json(self.root / "BENCHMARK.json")
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        base = self.root / "benchmark"
        self.cfg = cfg or load_json(base / "configs" / f"{self.workload['config']}.json")
        self.mix = mix or load_json(base / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = limits or load_json(base / "limits" / f"{name}.json")["numbers"]
        self.name = name
        self.end_to_end = [m for m in self.manifest["end_to_end"] if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def mode(self):
        return named.load("modes", self.mix["mode"])

    def reader(self, metric: str):
        return named.load("layer_metrics", metric)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_block(device: torch.device, count: int) -> dict:
    """The card, as the port's ``utils/measure.py::device_block`` names it (a copy): its name, power limit
    and the cards the run uses."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[device.index or 0].strip()
    limit = line.rsplit(",", 1)[1].strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "power_limit_w": float(limit.split()[0]) if limit[:1].isdigit() else None, "nvidia_smi": line}


def sample(seed: int, population: list, k: int) -> list:
    rng = np.random.default_rng(derive_seed(seed, SAMPLE_TAG))
    return sorted(rng.choice(population, size=min(k, len(population)), replace=False).tolist())


def free() -> None:
    """Return the program's freed device memory, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        chips: Optional[int] = None) -> tuple:
    """(result line, check lines for standard error). Raises CellError where no result may be printed."""
    device = torch.device(device)
    out = {"problems": []}
    cell.mode().run(cell, seed, seconds, trace, device, t_start, out)
    ctx = out["ctx"]

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": units[m["name"]]}

    # the check, with the program's state freed
    if out["rows"]:
        numbers = check.worst(check.judge_rows(cell.cfg, seed, cell.mix["steps"], out["rows"], device))
        ok, shown = check.verdict(numbers, cell.limits)
    else:
        ok, shown = False, {k: {"value": None, "limit": v["limit"]} for k, v in cell.limits.items()}
        out["problems"].append("no request to check")
    ok = ok and not out["problems"]

    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of the JAX package's world are loaded: {bad}")
    dev = device_block(device, chips or 1)
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    line = {"correct": bool(ok), "attempted": int(out["attempted"]), "failed": int(out["failed"]), "metrics": metrics,
            "device": dev}
    if trace and ctx.trace is not None:
        dev["busy_s"], dev["window_s"] = ctx.trace.busy_s, ctx.trace.window_s
        line["breakdown"] = {"device_ops": ctx.trace.top_device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    line["check"] = shown
    notes = [f"checked {out['checked']}"] + [f"problem: {p}" for p in out["problems"]]
    if "late" in out:
        notes.insert(0, "generator " + " ".join(f"{k} {v}" for k, v in out["late"].items()))
    notes += [f"check {k} {v['value']} limit {v['limit']}" for k, v in shown.items()]
    return line, notes
