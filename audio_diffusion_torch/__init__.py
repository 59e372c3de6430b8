"""audio_diffusion_torch — the PyTorch/CUDA port of audio_diffusion_tpu.

Runs unconditional and conditional (``encoding=``) latent and pixel
generation and its serving path on an NVIDIA H100: mel DSP, DDIM and DDPM,
the UNet (with the cross-attention blocks), the KL-VAE and the AudioEncoder,
the pipeline (audio-to-audio, inversion, diffusers-layout save/load) and the
batching HTTP server (``serving``), with hand-written CUDA kernels (``csrc/``)
for fused GroupNorm+SiLU and many-small-heads attention. Imports torch, numpy
and scipy, never JAX.
"""

VERSION = "0.1.0"
__version__ = VERSION

from .mel import Mel, MelConfig  # noqa: F401,E402


def __getattr__(name):
    if name == "AudioDiffusionPipeline":
        from .pipelines.pipeline import AudioDiffusionPipeline

        return AudioDiffusionPipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
