"""The whole request's share of the card's bf16 peak: the request's FLOPs (the UNet x steps and the VAE
decode, counted over the benchmark's reference models by the configuration's family, ``families/<family>.py::flops``)
times the window's requests, over the window's seconds, over 989 TFLOP/s."""

from benchmark.core import named
from benchmark.counts import peaks


def read(ctx):
    w = ctx.window
    total = named.family(ctx.cfg).flops(ctx.cfg, ctx.mix)["total"]
    return 100.0 * total * w.requests / w.window_s / peaks.BF16_FLOPS
