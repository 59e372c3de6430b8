"""The GroupNorm+SiLU kernel's share of its roofline (``csrc/group_norm_silu.cu``) over the traced
requests: see ``core/readers.py::roofline_pct`` and ``counts/kernels.py``."""

from benchmark.core.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "gn_silu")
