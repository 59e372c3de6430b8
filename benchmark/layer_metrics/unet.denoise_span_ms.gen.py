"""ms of the 50-step denoise (UNet + DDIM, ``models/unet2d.py``, ``schedulers/ddim.py``) inside each traced
request's fused CUDA graph: the device's busy time from the end of stage mark 0 (the request's start) to the
start of mark 1 (``core/spans.py::stage_ms``), the median over the traced requests."""

from benchmark.core.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, 0)
