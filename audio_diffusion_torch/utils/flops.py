"""FLOP counts of the port's models: the work that ``scripts/mfu.py`` (and a
benchmark's ``mfu``) divides by time.

**The definition.** Two FLOPs per multiply-add of every matrix product and
convolution the model's algorithm performs, and nothing else:

- a convolution at its nominal taps: ``2 * Cin/groups * Cout * kh * kw * Hout
  * Wout`` per image, the taps that fall on zero padding included;
- a linear layer ``2 * rows * in * out``;
- attention its two products, ``4 * B * heads * N * M * d``;
- not counted: elementwise work, normalisation (GroupNorm is no work by this
  definition), softmax, SiLU, the nearest upsample, the scheduler's step,
  FFTs.

This is what ``torch.utils.flop_counter.FlopCounterMode`` counts, and it is
counted so: over one forward of a stand-in of the model built from its config
(f32, zero weights, on the CPU), where every op is a kernel's plain PyTorch
version. The count therefore depends on the configuration and the shapes
alone, not on the weights, the compute dtype or ``fused_groupnorm``, and it is
the same whether the hand-written kernels or their plain versions run the
model on the card: a counter cannot see the kernels' launches, and it need not.

**Against XLA.** ``cost_analysis()["flops"]`` of the JAX package's compiled
UNet counts otherwise: a convolution only at its valid taps (taps on padding,
and on the holes of an lhs-dilated input, are left out) and one FLOP per
element of elementwise work. The latent UNet's deepest levels are 2x2 and 1x1,
where most 3x3 taps fall on padding, and the JAX package's default
``dilated_upsample`` computes nearest-x2 + 3x3 as one 4x4 lhs-dilated
convolution of 4 valid taps per output instead of 9, so XLA's count lies below
this one (``tests/test_torch_bench.py`` holds the difference to those two
rules).

The UNet's work is affine in the batch, not proportional: its time path runs
once per distinct timestep (one per pipeline step), whatever the rows. So a
forward is counted at batch 1 and 2 and extended. The VAE decode has no such
part and is counted at batch 1.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig

# Dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet), TFLOP/s.
PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}


def peak_precision(dtype: str) -> str:
    """The tensor-core precision a run in ``dtype`` computes its products in:
    bf16; for f32, TF32 when cuDNN's or cuBLAS's TF32 flag lets it run, else
    plain f32."""
    if dtype == "bfloat16":
        return "bfloat16"
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "float32"


def count(fn) -> int:
    """FLOPs of ``fn()`` by the module's definition (``FlopCounterMode``)."""
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _stand_in(cls, config):
    """``cls(config)`` in f32 on the CPU with zero weights, built without an initialiser."""
    with torch.device("meta"):
        module = cls(dataclasses.replace(config, dtype="float32"))
    module = module.to_empty(device="cpu")
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            t.zero_()
    return module.eval()


def unet_forward_flops(config: UNetConfig, batch: int = 1, encoder_seq: int = 1) -> int:
    """One UNet forward of ``batch`` rows at one timestep, as each denoise
    step calls it (a conditional UNet with an encoding of ``encoder_seq``)."""
    unet = _stand_in(UNet2D, config)
    h, w = config.sample_hw()

    def forward(rows):
        enc = (torch.zeros((rows, encoder_seq, config.cross_attention_dim)) if config.is_conditional else None)
        return lambda: unet(torch.zeros((rows, h, w, config.in_channels)), torch.tensor(0), enc)

    one, two = count(forward(1)), count(forward(2))
    return one + (batch - 1) * (two - one)


def vae_decode_flops(config: VAEConfig, image_hw, batch: int = 1) -> int:
    """The VAE decode of ``batch`` latents of an ``image_hw`` image."""
    vae = _stand_in(AutoencoderKL, config)
    lh, lw = config.latent_hw(*image_hw)
    return batch * count(lambda: vae.decode(torch.zeros((1, lh, lw, config.latent_channels))))
