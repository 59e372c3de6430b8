"""Configurations at a size a CPU test holds: the cells' shapes of blocks, at a few channels and pixels, as each
configuration's family cuts them (``tiny``)."""

import json
from pathlib import Path

from benchmark.core import named

ROOT = Path(__file__).resolve().parents[2]


def _load(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json").read_text())


def config(name: str, dtype: str = "float32") -> dict:
    """The configuration ``name`` cut to a CPU's size by its family, computing in ``dtype``."""
    cfg = _load("configs", name)
    cfg = named.family(cfg).tiny(cfg)
    cfg["dtype"] = dtype
    return cfg


def mix(name: str, **over) -> dict:
    m = _load("traffic", name)
    m.update(steps=3, **over)
    return m


LOOSE = {"spec_mae": {"limit": 1000.0}, "audio_rel": {"limit": 1000.0}}
