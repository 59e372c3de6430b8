"""Command-line entry points, run as ``python -m audio_diffusion_torch.scripts.<name>``."""
