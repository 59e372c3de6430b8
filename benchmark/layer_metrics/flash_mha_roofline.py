"""The many-small-heads attention kernel's share of its roofline (``csrc/mha.cu``) over the traced
requests: see ``core/readers.py::roofline_pct`` and ``counts/kernels.py``."""

from benchmark.core.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flash_mha")
