"""Serving: dynamic request batching and a minimal HTTP server
(port of ``audio_diffusion_tpu/serving``).

    python -m audio_diffusion_torch.serving --model DIR --dtype bfloat16 --fused_groupnorm
"""

from .batcher import DynamicBatcher, GenerationResult, QueueFull
from .server import AudioDiffusionServer, make_server

__all__ = ["DynamicBatcher", "GenerationResult", "QueueFull", "AudioDiffusionServer", "make_server"]
