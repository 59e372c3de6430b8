"""ms of the mel inversion (NNLS + Griffin-Lim + int16 PCM, ``ops/griffin_lim.py``, ``mel.py``) inside each
traced request's fused CUDA graph: the device's busy time from the end of stage mark 2 to the start of mark 3
(``core/spans.py::stage_ms``), the median over the traced requests."""

from benchmark.core.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, 2)
