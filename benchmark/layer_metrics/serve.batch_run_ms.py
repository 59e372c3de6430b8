"""The mean ``run_s`` (from the pipeline call to the results on the host) of the window's batches in the
batcher's per-batch ``stats`` as the harness copied them (``core/drivers.py::BatchLog``), in ms; the
profiler runs only after the window (``core/drivers.py::traced_tail``)."""


def read(ctx):
    batches = getattr(ctx, "batches", None)
    if not batches:
        return None
    return 1e3 * sum(s["run_s"] for s in batches) / len(batches)
