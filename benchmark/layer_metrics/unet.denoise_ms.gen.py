"""ms of the 50-step denoise of one request (UNet + DDIM, ``models/unet2d.py``, ``schedulers/ddim.py``): CUDA
events around replays of the pipeline's staged ``denoise`` program at the cell's batch."""

NEEDS = ("stages",)


def read(ctx):
    return (ctx.stage_ms or {}).get("denoise")
