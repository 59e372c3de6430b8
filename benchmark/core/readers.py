"""What the per-layer readers share: the idle share of the traced sub-window, and a kernel's share of its
roofline over the traced requests."""

from __future__ import annotations

from ..counts import kernels
from . import named


class ReadError(RuntimeError):
    """A reader found its inputs inconsistent: the traced run fails."""


def idle_pct(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline_pct(ctx, kernel: str):
    """The least time the card could take for ``kernel``'s calls in the traced requests (from the
    configuration's shapes, as its family counts them: ``kernel_calls``) over the profiler's summed device time
    of those calls. Fails the run where the profiler's launches differ from the count from shapes, or the share
    passes 105%."""
    if ctx.trace is None or not getattr(ctx, "traced_requests", 0):
        return None
    calls, least, per_request = named.family(ctx.cfg).kernel_calls(kernel, ctx.cfg, ctx.mix)
    if not calls:
        return None
    forwards = per_request * ctx.traced_requests
    lo, hi = ctx.trace.window
    ops = [o for o in ctx.trace.device_ops if kernels.KERNELS[kernel].search(o.name) and lo <= o.start < hi]
    if len(ops) != calls * forwards:
        raise ReadError(f"{kernel}: the profiler saw {len(ops)} launches, the shapes give {calls * forwards}")
    share = 100.0 * least * forwards / sum(o.dur for o in ops)
    if share > 105.0:
        raise ReadError(f"{kernel}: {share:.2f}% of its roofline: the count or the time is wrong")
    return share
