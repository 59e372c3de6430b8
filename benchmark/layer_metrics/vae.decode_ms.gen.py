"""ms of the VAE decode and uint8 postprocess of one request (``models/vae.py``): CUDA events around
replays of the pipeline's staged ``vae_decode`` program at the cell's batch."""

NEEDS = ("stages",)


def read(ctx):
    return (ctx.stage_ms or {}).get("vae_decode")
