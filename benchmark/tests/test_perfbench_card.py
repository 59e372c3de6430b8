"""A cell run on the card, end to end, through the benchmark's command (skips without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_gen_cell_on_the_card(card, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "latent-256.gen-b32", "--seed",
                          str(2**31 + 77), "--seconds", "2", "--trace", str(trace)], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "check" and line["failed"] == 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "gn_silu_roofline" in line["metrics"] and len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
