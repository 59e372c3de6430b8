"""Pinned-seed rebuild of the trained conditional-latent-512 pipeline (port
of ``scripts/rebuild_latent512.sh``; the recipe is :mod:`.rebuild`'s):

    python -m audio_diffusion_torch.scripts.rebuild_latent512 [--output DIR] [--work DIR]

writes ``models/conditional-latent-audio-diffusion-512`` by default: the
512 KL-VAE to 64x64 latents and the cross-attention UNet conditioned on the
seeded AudioEncoder's 100-d encodings of the corpus. The last line of the
output is the recipe's JSON line.
"""

from .rebuild import CONDITIONAL_512, main

if __name__ == "__main__":
    main(CONDITIONAL_512)
