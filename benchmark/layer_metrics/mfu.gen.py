"""The whole request's share of the card's bf16 peak: the request's FLOPs (the UNet x steps and the VAE
decode, counted over the benchmark's reference models, ``counts/flops.py``) times the window's requests,
over the window's seconds, over 989 TFLOP/s."""

from benchmark.counts import flops, peaks


def read(ctx):
    w = ctx.window
    total = flops.request(ctx.cfg, ctx.mix["batch"], ctx.mix["steps"])["total"]
    return 100.0 * total * w.requests / w.window_s / peaks.BF16_FLOPS
