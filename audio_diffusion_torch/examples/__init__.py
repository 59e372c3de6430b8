"""Runnable forms of the reference's notebooks on the port (ports of ``examples/*.py``):
``python -m audio_diffusion_torch.examples.<name> ... [--device cpu]``."""
