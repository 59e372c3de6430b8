"""The nearest-rank 95th percentile, in ms, of every row's ``wait_ms`` (from ``submit`` to the batcher's worker
taking its batch) over the window's batches, from the batcher's ``stats`` as the harness copied them
(``core/drivers.py::BatchLog``)."""

from benchmark.core.drivers import p95
from benchmark.core.spans import card_batches


def read(ctx):
    batches = card_batches(ctx)
    if batches is None:
        return None
    return p95([w for b in batches for w in b["wait_ms"]])
