"""Configurations at a size a CPU test holds: the cells' shapes of blocks, at a few channels and pixels."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _load(kind, name):
    return json.loads((ROOT / "benchmark" / kind / f"{name}.json").read_text())


def config(name: str, dtype: str = "float32") -> dict:
    """The configuration ``name`` with its widths and pixels cut to a CPU's size, its block types kept."""
    cfg = copy.deepcopy(_load("configs", name))
    u = cfg["unet"]
    n = len(u["block_out_channels"])
    u["block_out_channels"] = [16 * (1 + i // 2) for i in range(n)]
    u["sample_size"] = [2 ** (n - 1), 2 ** (n - 1)]
    u["norm_num_groups"] = 8
    u["layers_per_block"] = 1
    if u.get("cross_attention_dim"):
        u["cross_attention_dim"] = cfg["encoding"]["dim"] = 12
    v = cfg["vae"]
    v["block_out_channels"] = [8, 8]
    v["norm_num_groups"] = 4
    v["layers_per_block"] = 1
    v["sample_size"] = 2 * u["sample_size"][0]
    side = v["sample_size"]
    cfg["mel"].update(x_res=side, y_res=side, n_fft=128, hop_length=32, n_iter=4)
    cfg["dtype"] = dtype
    return cfg


def mix(name: str, **over) -> dict:
    m = _load("traffic", name)
    m.update(steps=3, **over)
    return m


LOOSE = {"spec_mae": {"limit": 1000.0}, "audio_rel": {"limit": 1000.0}}
