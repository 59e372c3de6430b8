"""ms of the mel inversion of one request (NNLS + Griffin-Lim + int16 PCM, ``ops/griffin_lim.py``,
``mel.py``): CUDA events around replays of the pipeline's staged ``audio`` program at the cell's batch."""

NEEDS = ("stages",)


def read(ctx):
    return (ctx.stage_ms or {}).get("audio")
