"""The batcher's worker's host time per batch, in ms: the mean ``assemble_ms + launch_ms`` of the window's
batches (the batch's inputs made, then the pipeline call and the copy's start; a blocked hand-over to the
finisher left out), from the batcher's ``stats`` as the harness copied them (``core/drivers.py::BatchLog``)."""

from benchmark.core.spans import card_batches


def read(ctx):
    batches = card_batches(ctx)
    if batches is None:
        return None
    return sum(b["assemble_ms"] + b["launch_ms"] for b in batches) / len(batches)
