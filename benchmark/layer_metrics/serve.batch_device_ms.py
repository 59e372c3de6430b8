"""The mean ``device_ms`` of the window's batches: CUDA events on the pipeline's stream just before the batcher's
pipeline call and just after it returns (the batch's time on the card, from the stream reaching it), from the
batcher's ``stats`` as the harness copied them (``core/drivers.py::BatchLog``)."""

from benchmark.core.spans import card_batches


def read(ctx):
    batches = card_batches(ctx)
    if batches is None:
        return None
    return sum(b["device_ms"] for b in batches) / len(batches)
