"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit): the
denominators of every roofline and ``mfu`` share the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
F32_FLOPS = 67e12  # outside the tensor cores
# The special-function unit: 16 exponentials per clock per SM at compute capability 9.0, 132 SMs, 1.98 GHz.
EXP_PER_S = 16 * 132 * 1.98e9
