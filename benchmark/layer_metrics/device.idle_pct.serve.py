"""The share of the open loop's traced sub-window (the window's last ``trace_s`` seconds of arrivals sent
again after it, until every one is answered: ``core/drivers.py::traced_tail``) in which no operation runs on
the card (``torch.profiler``)."""

from benchmark.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
