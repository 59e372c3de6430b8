"""Pinned-seed rebuild of the trained latent-256 pipeline (port of
``scripts/rebuild_latent256.sh``; the recipe is :mod:`.rebuild`'s):

    python -m audio_diffusion_torch.scripts.rebuild_latent256 [--output DIR] [--work DIR]

writes ``models/latent-audio-diffusion-256`` by default, the directory whose
presence makes ``python -m audio_diffusion_torch.bench`` bench the trained
pipeline beside the random-init one. The last line of the output is the
recipe's JSON line.
"""

from .rebuild import LATENT_256, main

if __name__ == "__main__":
    main(LATENT_256)
