"""audio_diffusion_torch — the PyTorch/CUDA port of audio_diffusion_tpu.

Runs unconditional and conditional (``encoding=``) latent and pixel
generation and its serving path on an NVIDIA H100: mel DSP, DDIM and DDPM,
the UNet (with the cross-attention blocks), the KL-VAE and the AudioEncoder,
the pipeline (audio-to-audio, inversion, diffusers-layout save/load), the
convenience API (``AudioDiffusion`` with ``loop_it``, ``pipelines.stitch``'s
outpaint and remix, ``apps``), the batching HTTP server (``serving``),
training (``training``) and dataset preparation (``data.prepare``,
``scripts``), with hand-written CUDA kernels (``csrc/``) for fused
GroupNorm+SiLU and many-small-heads attention. Imports torch, numpy, scipy
and PIL, never JAX.
"""

VERSION = "0.1.0"
__version__ = VERSION

from .mel import Mel, MelConfig  # noqa: F401,E402


def __getattr__(name):
    if name == "AudioDiffusion":
        from .audio_diffusion import AudioDiffusion

        return AudioDiffusion
    if name == "AudioDiffusionPipeline":
        from .pipelines.pipeline import AudioDiffusionPipeline

        return AudioDiffusionPipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
