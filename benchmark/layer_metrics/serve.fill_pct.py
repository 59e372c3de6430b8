"""Real rows over dispatched rows of the window's batches, from the batcher's per-batch ``stats`` as the
harness copied them (``core/drivers.py::BatchLog``); the profiler runs only after the window."""


def read(ctx):
    batches = getattr(ctx, "batches", None)
    if not batches:
        return None
    return 100.0 * sum(s["n"] for s in batches) / sum(s["tier"] for s in batches)
