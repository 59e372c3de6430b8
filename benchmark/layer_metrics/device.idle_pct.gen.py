"""The share of the traced requests' window in which no operation runs on the card (``torch.profiler``)."""

from benchmark.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
