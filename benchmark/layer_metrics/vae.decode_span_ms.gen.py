"""ms of the VAE decode and uint8 postprocess (``models/vae.py``) inside each traced request's fused CUDA
graph: the device's busy time from the end of stage mark 1 to the start of mark 2 (``core/spans.py::stage_ms``),
the median over the traced requests."""

from benchmark.core.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, 1)
