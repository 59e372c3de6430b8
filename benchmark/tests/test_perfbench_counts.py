"""The yardstick's counts against hand counts: FLOPs, kernel calls and bytes, and the roofline reader."""

import types

import pytest
import torch

from benchmark.core import named, profile
from benchmark.core.readers import ReadError, roofline_pct
from benchmark.counts import flops, kernels, peaks
from benchmark.reference.models import Arith, ResnetBlock, SpatialSelfAttention
from benchmark.tests import tiny


AD = named.load("families", "audio_diffusion")


def _count(fn):
    return flops.count(fn)


def test_resnet_block_flops_by_hand():
    b, cin, cout, h, w, temb = 2, 8, 16, 4, 4, 32
    blk = ResnetBlock(Arith(), cin, cout, temb, 4, 1e-5)
    x, t = torch.zeros(b, cin, h, w), torch.zeros(1, temb)
    hand = 2 * (b * h * w * cout * cin * 9 + b * h * w * cout * cout * 9 + b * h * w * cout * cin + temb * cout)
    assert _count(lambda: blk(x, t)) == hand


def test_attention_flops_by_hand():
    b, c, h, w = 2, 16, 2, 2
    att = SpatialSelfAttention(Arith(), c, 8, 4, 1e-5)
    n, heads, d = h * w, 2, 8
    hand = 4 * 2 * b * n * c * c + 4 * b * heads * n * n * d
    assert _count(lambda: att(torch.zeros(b, c, h, w))) == hand


def test_latent_256_request_flops():
    """PERF.md's figures of the port's own count (utils/flops.py), which the reference's count matches."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "latent-256.json").read_text())
    cfg["unet"]["sample_size"] = [32, 32]
    assert AD.unet_forward(cfg, 1) * 50 == pytest.approx(12394138828800 / 32, rel=0.01)


def test_kernel_calls_of_the_latent_256_unet():
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "latent-256.json").read_text())
    gn = kernels.gn_silu_calls(cfg, 32)
    assert len(gn) == 64 and gn[0] == (32, 128, 32, 32)
    assert kernels.mha_calls(cfg, 32) == [(32, 64, 4, 8)] * 2 + [(32, 64, 1, 8)] + [(32, 64, 4, 8)] * 3
    cond = json.loads((Path(__file__).resolve().parents[1] / "configs" / "cond-latent-512.json").read_text())
    assert kernels.mha_calls(cond, 16) == [] and len(kernels.gn_silu_calls(cond, 16)) == 2 * (8 + 2 + 12)


def test_least_times_by_hand():
    b, c, h, w = 4, 64, 8, 8
    assert kernels.gn_silu_least_s((b, c, h, w), "bfloat16") == pytest.approx(
        (2 * b * c * h * w * 2 + 2 * c * 4) / peaks.HBM_BYTES_PER_S)
    shape = (2, 8, 1024, 8)
    tensor = 4 * 2 * 8 * 1024 * 1024 * 8 / peaks.BF16_FLOPS
    exp = 2 * 8 * 1024 * 1024 / peaks.EXP_PER_S
    nbytes = 4 * 2 * 8 * 1024 * 8 * 2 / 3.35e12
    assert kernels.mha_least_s(shape, "bfloat16") == pytest.approx(max(tensor, exp, nbytes))


def _ctx(n_ops, dur):
    cfg = tiny.config("latent-256")
    cfg["fused_groupnorm"] = True
    mix = {"batch": 2, "steps": 3}
    calls, least = kernels.per_forward("gn_silu", cfg, 2)
    tr = profile.Trace(window=(0.0, 10.0))
    tr.device_ops = [profile.Op("void gn_silu_warp_kernel<float>(...)", 0.001 * i, dur) for i in range(n_ops)]
    tr.device_ops.append(profile.Op("void other_kernel(...)", 0.0, 1.0))
    return types.SimpleNamespace(cfg=cfg, mix=mix, trace=tr, traced_requests=2), calls, least


def test_roofline_reader():
    ctx, calls, least = _ctx(0, 0)
    expected = calls * 3 * 2
    per_call = least / calls
    ctx, *_ = _ctx(expected, per_call / 0.5)
    assert roofline_pct(ctx, "gn_silu") == pytest.approx(50.0)
    with pytest.raises(ReadError, match="launches"):
        roofline_pct(_ctx(expected - 1, least)[0], "gn_silu")
    with pytest.raises(ReadError, match="roofline"):
        roofline_pct(_ctx(expected, per_call / 1.2)[0], "gn_silu")
    ctx.trace = None
    assert roofline_pct(ctx, "gn_silu") is None


def test_trace_busy_and_gaps():
    tr = profile.Trace(window=(1.0, 2.0))
    tr.device_ops = [profile.Op("a", 0.9, 0.2), profile.Op("b", 1.05, 0.1), profile.Op("c", 1.5, 0.2)]
    tr.host_ops = [profile.Op("outer", 1.0, 1.0), profile.Op("inner", 1.3, 0.1)]
    assert tr.busy_s == pytest.approx(0.15 + 0.2)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["inner", pytest.approx(0.35)] and gaps[1] == ["outer", pytest.approx(0.3)]
