"""The open loop's arithmetic (latency from the due time, shed and lost requests failed and counted in the
tail), its record of the batcher's batches, and the closed loop's rate over all the window's work, on fakes
of the program."""

import threading
import time
import types
from collections import deque
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from audio_diffusion_torch.serving.batcher import QueueFull
from benchmark.core import drivers, named
from benchmark.core.errors import CellError


class FakeBatcher:
    """Answers each request ``delay`` seconds after its submit, as a batch of its own (``batches`` entries of
    ``stats``, which keeps the last ``keep``, per answer); sheds the ones listed; loses the ones listed."""

    def __init__(self, delay, shed=(), lose=(), stall=0.0, keep=256, batches=1):
        self.delay, self.shed, self.lose, self.stall = delay, set(shed), set(lose), stall
        self.n = 0
        self.outstanding = 0  # submitted and not answered yet
        self.timers = []
        self._stats_lock = threading.Lock()
        self.stats = deque(maxlen=keep)
        self.batches_run = 0
        self.batches = batches

    def _answer(self, fut, j):
        with self._stats_lock:
            for _ in range(self.batches):
                self.batches_run += 1
                self.stats.append({"n": 1, "tier": 2, "run_s": self.delay, "request": j})
            self.outstanding -= 1
        fut.set_result(j)

    def latency_summary(self):
        return {"queued": 0}

    def submit(self, seed, steps, eta):
        j = self.n
        self.n += 1
        if j in self.shed:
            raise QueueFull("full", 1.0)
        if j == 0 and self.stall:
            time.sleep(self.stall)  # the system holds the caller: later requests go late
        fut = Future()
        fut.set_running_or_notify_cancel()
        if j not in self.lose:
            with self._stats_lock:
                self.outstanding += 1
            t = threading.Timer(self.delay, self._answer, args=(fut, j))
            t.start()
            self.timers.append(t)
        return fut


MIX = {"arrivals": "exponential_quantiles", "rate_per_s": 20.0, "steps": 1, "eta": 0.0, "drain_s": 0.5,
       "trace_s": 0.0}


def test_latency_counts_from_the_due_time():
    res = drivers.run_open(FakeBatcher(0.05, stall=0.3), MIX, 3, 1.0)
    late = res.late_s
    assert res.completed == 20 and res.failed == 0
    # each latency is the system's time after submit plus how late the submit was
    assert np.all(res.latency_s >= late + 0.045)
    assert late[1] > 0.2  # the stall made the next arrival late, and it counts
    assert drivers.p95(res.latency_s) == np.sort(res.latency_s)[18] > 0.25  # rank 19 of 20


def test_shed_and_lost_requests_fail_and_count_in_the_tail():
    res = drivers.run_open(FakeBatcher(0.01, shed={2, 5}, lose={7}), MIX, 4, 1.0)
    assert res.failed == 3 and res.completed == 17 and sum(res.shed) == 2
    # a missing request counts its whole wait: through the window and the drain
    for j in (2, 5, 7):
        assert res.latency_s[j] >= 1.0 + 0.5 - res.due[j] - 0.01
    assert drivers.p95(res.latency_s) >= 0.5


def test_p95_is_over_all_requests():
    assert drivers.p95(list(range(1, 101))) == 95
    assert drivers.p95([0.1] * 94 + [9.0] * 6) == 9.0
    assert drivers.p95([0.1] * 95 + [9.0] * 5) == 0.1


class FakePipe:
    device = torch.device("cpu")

    def __init__(self, seconds):
        self.seconds = seconds
        self.calls = 0

    def __call__(self, noise, **kw):
        self.calls += 1
        time.sleep(self.seconds)
        return torch.zeros((noise.shape[0], 4, 4), dtype=torch.uint8), torch.zeros((noise.shape[0], 8),
                                                                                   dtype=torch.int16)


@pytest.mark.parametrize("seconds", [0.3, 0.5])
def test_closed_rate_is_all_rows_over_all_the_time(seconds):
    from benchmark.tests import tiny

    cfg, mix = tiny.config("latent-256"), tiny.mix("gen-b32", batch=4)
    pipe = FakePipe(0.04)
    res = drivers.run_closed(pipe, cfg, mix, 1, seconds=seconds, first=1)
    assert res.requests == pipe.calls and res.rows == 4 * pipe.calls
    assert res.window_s >= seconds and res.window_s >= 0.04 * pipe.calls
    assert sorted(res.outputs) == list(range(1, pipe.calls + 1))


class IdleTracer:
    """Stands in for the profiler, whose stop holds the host; notes what the batcher had outstanding at its
    start and stop."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.calls = []

    def start(self):
        self.calls.append(("start", time.monotonic(), self.batcher.outstanding))

    def stop(self):
        self.calls.append(("stop", time.monotonic(), self.batcher.outstanding))
        time.sleep(0.5)


def test_the_trace_starts_and_stops_with_the_batcher_idle():
    batcher = FakeBatcher(0.05)
    tracer = IdleTracer(batcher)
    mix = dict(MIX, trace_s=0.3)
    res = drivers.run_open(batcher, mix, 5, 1.0)
    assert tracer.calls == [] and res.completed == 20 and len(res.batches) == 20
    tail = drivers.traced_tail(batcher, mix, res, tracer)
    (start, t_start, busy_start), (stop, t_stop, busy_stop) = tracer.calls
    assert (start, stop) == ("start", "stop") and busy_start == busy_stop == 0
    # the window's last trace_s seconds of arrivals, sent again on their schedule and all answered
    last = res.due >= res.due[-1] - 0.3
    assert len(tail.due) == int(last.sum()) >= 2 and tail.completed == len(tail.due)
    np.testing.assert_allclose(tail.due, res.due[last] - res.due[last][0])
    assert tail.seeds == [s for s, k in zip(res.seeds, last) if k]
    assert t_stop - t_start >= tail.due[-1] + 0.05


def test_no_trace_after_a_window_that_left_requests_behind():
    batcher = FakeBatcher(0.01, lose={3})
    tracer = IdleTracer(batcher)
    res = drivers.run_open(batcher, MIX, 8, 1.0)
    assert res.failed == 1
    assert drivers.traced_tail(batcher, dict(MIX, trace_s=0.3), res, tracer) is None and tracer.calls == []


def test_the_log_keeps_more_batches_than_the_batcher():
    res = drivers.run_open(FakeBatcher(0.01, keep=4), MIX, 6, 1.0)
    assert len(res.batches) == 20
    assert [s["request"] for s in res.batches] == list(range(20))
    ctx = types.SimpleNamespace(batches=res.batches)
    assert named.load("layer_metrics", "serve.fill_pct").read(ctx) == 50.0
    assert named.load("layer_metrics", "serve.batch_run_ms").read(ctx) == pytest.approx(10.0)


def test_a_lost_batch_entry_gives_no_result():
    with pytest.raises(CellError, match="lost"):
        drivers.run_open(FakeBatcher(0.01, keep=2, batches=3), MIX, 7, 1.0)


def test_an_open_loop_cell_needs_a_family_that_serves(monkeypatch):
    mode = named.load("modes", "open")
    monkeypatch.setattr(named, "family", lambda cfg: types.SimpleNamespace(program=None))
    with pytest.raises(CellError, match="toy.*served_inputs"):
        mode.served_family({"family": "toy"})
