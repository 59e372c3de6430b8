"""What the harness reads for the cells, pinned to the values recorded before the model families were split out
(``pinned.json``): the FLOPs behind ``mfu.gen``, the kernel calls behind the two rooflines, a served request's
noise, and ``check.judge_rows``' per-row numbers (the reference, the control and its UNet-only reading) on the
tiny configurations. A change to the harness that moves any of them moves the cells' readings."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.core import check, named, traffic
from benchmark.counts import kernels
from benchmark.tests import tiny

PINNED = json.loads((Path(__file__).resolve().parent / "pinned.json").read_text())
CELLS = {"latent-256": ("gen-b32", 32), "cond-latent-512": ("gen-b16", 16)}
SEEDS = (2**31 + 99, 12345)


@pytest.mark.parametrize("name", CELLS)
def test_flops_and_kernel_calls_at_the_cells_shapes(name):
    cfg, (mix_name, batch) = tiny._load("configs", name), CELLS[name]
    mix = dict(tiny._load("traffic", mix_name))
    assert (mix["batch"], mix["steps"]) == (batch, 50)
    fam = named.family(cfg)
    assert fam.flops(cfg, mix) == PINNED["flops"][name]
    assert [list(c) for c in kernels.gn_silu_calls(cfg, batch)] == PINNED["gn_silu_calls"][name]
    assert [list(c) for c in kernels.mha_calls(cfg, batch)] == PINNED["mha_calls"][name]
    for kernel in ("gn_silu", "flash_mha"):
        calls, least, forwards = fam.kernel_calls(kernel, cfg, mix)
        assert [calls, least] == PINNED["per_forward"][kernel][name] and forwards == 50


def test_served_noise():
    fam = named.family(tiny.config("latent-256"))
    got = [float(fam.served_inputs(tiny.config("latent-256"), s)["noise"].double().sum()) for s in (3, 2**40 + 7)]
    assert got == PINNED["served_noise_sums"]


def rows(cfg, mix, seed):
    """Request 1's rows with program outputs drawn from the seed: uint8 images and int16 audio of the cell's
    shapes, independent of the program."""
    inp = traffic.closed_inputs(cfg, mix, seed, 1, "cpu")
    g = torch.Generator().manual_seed(seed % 2**32)
    m = cfg["mel"]
    out = []
    for r in range(mix["batch"]):
        image = torch.randint(0, 256, (m["y_res"], m["x_res"]), generator=g, dtype=torch.uint8).numpy()
        audio = torch.randint(-20000, 20000, ((m["x_res"] - 1) * m["hop_length"],), generator=g,
                              dtype=torch.int16).numpy()
        out.append(dict({k: v[r] for k, v in inp.items()}, image=image, audio=audio))
    return out


@pytest.mark.parametrize("precision", ["float32", "fp8", "fp8-unet"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_judge_rows(name, seed, precision):
    cfg, mix = tiny.config(name), tiny.mix(CELLS[name][0], batch=3)
    got = check.judge_rows(cfg, seed, mix["steps"], rows(cfg, mix, seed), torch.device("cpu"), precision=precision)
    want = PINNED["judge"][f"{name}/{seed}/{precision}"]
    if precision == "float32":
        assert got == want  # the same to every digit, also at other thread counts
    else:
        # float8's rounding flips a value at its boundary where the CPU's summation order changes (2.4% in one
        # row between 2 and 4 threads); anything that changes the arithmetic moves these by far more
        assert got == {k: pytest.approx(v, rel=0.05, abs=1e-9) for k, v in want.items()}
