"""The share of the open loop's traced tail (``core/drivers.py::traced_tail``) in which no operation runs on the
card while the batcher's worker is inside ``adt.serve.hold``, ``assemble``, ``launch`` or ``backpressure``: the
part of ``device.idle_pct.serve`` with requests in the batcher's hands (``core/spans.py::idle_queued_pct``, the
program's spans from ``audio_diffusion_torch/utils/profiling.py::spans``)."""

from benchmark.core.spans import idle_queued_pct


def read(ctx):
    from audio_diffusion_torch.utils import profiling

    if not hasattr(profiling, "spans"):  # a program that records no span
        return None
    return idle_queued_pct(ctx, profiling.spans(), profiling.dropped())
