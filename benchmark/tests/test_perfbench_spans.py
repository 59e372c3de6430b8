"""The readers of the program's own marks, spans and counters, on synthetic traces and batcher entries with
answers worked by hand: the stage split between the marks, the mark count's and order's errors, the
nearest-rank p95 over rows, the card's idle time inside the worker's spans, and nothing on the CPU."""

import collections
import types

import pytest

from benchmark.core import named
from benchmark.core.profile import Op, Trace
from benchmark.core.readers import ReadError

# the fields of the program's recorded spans (``audio_diffusion_torch/utils/profiling.py::Span``) the reader takes
Span = collections.namedtuple("Span", "name thread t0_ns t1_ns ids")
STAGES = ("unet.denoise_span_ms.gen", "vae.decode_span_ms.gen", "audio.nnls_gl_span_ms.gen")


def _read(metric, ctx):
    return named.load("layer_metrics", metric).read(ctx)


def _mark(k, t):
    return Op(f"void adt_stage_mark<{k}>()", t, 0.001)


def _request(t0, denoise, decode, audio):
    """One request from ``t0`` (s): mark 0, a kernel for each stage (times in s), the other marks after each."""
    ops = [_mark(0, t0)]
    t = t0 + 0.001
    for k, (name, dur) in enumerate((("unet", denoise), ("vae", decode), ("gl", audio)), start=1):
        ops.append(Op(name, t, dur))
        t += dur
        ops.append(_mark(k, t))
        t += 0.001
    return ops, t


def _gen_ctx(ops, requests, window=(0.0, 10.0)):
    return types.SimpleNamespace(trace=Trace(device_ops=ops, window=window), traced_requests=requests)


def test_stages_split_each_request_at_its_marks_and_take_the_median():
    a, t = _request(1.0, 0.200, 0.100, 0.050)
    b, t = _request(t + 0.010, 0.220, 0.080, 0.040)
    c, _ = _request(t + 0.010, 0.240, 0.090, 0.060)
    # a copy on another stream overlaps the second request's denoise: the union counts it once
    copy = Op("Memcpy DtoH", b[1].start + 0.010, 0.005)
    # a gap inside the first request's VAE stage: two kernels with 10 ms between them
    vae = a[3]
    a[3:4] = [Op("vae", vae.start, 0.040), Op("vae", vae.start + 0.050, 0.050)]
    ctx = _gen_ctx(a + b + c + [copy], 3)
    got = [_read(m, ctx) for m in STAGES]
    assert got == pytest.approx([220.0, 90.0, 50.0])
    assert _read(STAGES[1], _gen_ctx(a, 1)) == pytest.approx(90.0)  # 40 + 50 busy of the 100 ms between marks


def test_a_mark_missing_or_repeated_fails_the_run():
    a, t = _request(1.0, 0.2, 0.1, 0.05)
    b, _ = _request(t, 0.2, 0.1, 0.05)
    with pytest.raises(ReadError, match="traced requests"):
        _read(STAGES[0], _gen_ctx(a + b, 3))
    with pytest.raises(ReadError, match="traced requests"):
        _read(STAGES[0], _gen_ctx(a + b[:-1], 2))  # the second request's last mark lost
    with pytest.raises(ReadError, match="order"):
        _read(STAGES[0], _gen_ctx([o if o.name != a[0].name else _mark(0, 1.5) for o in a], 1))


def test_marks_outside_the_window_are_not_the_traced_requests():
    a, t = _request(1.0, 0.2, 0.1, 0.05)
    b, _ = _request(t + 1.0, 0.3, 0.1, 0.05)
    assert _read(STAGES[0], _gen_ctx(a + b, 1, window=(t + 0.5, t + 5.0))) == pytest.approx(300.0)


def test_no_marks_no_trace_or_no_requests_read_nothing():
    a, _ = _request(1.0, 0.2, 0.1, 0.05)
    unmarked = [o for o in a if "adt_stage_mark" not in o.name]
    assert _read(STAGES[0], _gen_ctx(unmarked, 1)) is None  # a program without marks
    assert _read(STAGES[0], types.SimpleNamespace(trace=None, traced_requests=0)) is None  # the CPU
    assert _read(STAGES[0], _gen_ctx(a, 0)) is None


def _batch(seq, waits, assemble, launch, device):
    return {"batch": seq, "n": len(waits), "tier": len(waits), "steps": 50, "run_s": 0.9, "copy_ms": 0.1,
            "wait_ms": waits, "assemble_ms": assemble, "launch_ms": launch, "device_ms": device}


def test_serving_counters_over_every_row_and_batch():
    waits = [[float(v) for v in range(1, 11)], [float(v) for v in range(11, 21)]]  # 20 rows: waits 1..20 ms
    batches = [_batch(0, waits[0], 2.0, 30.0, 700.0), _batch(1, waits[1], 4.0, 50.0, 800.0)]
    ctx = types.SimpleNamespace(batches=batches, trace=None)
    assert _read("serve.queue_wait_p95_ms", ctx) == 19.0  # rank ceil(0.95 * 20) = 19
    assert _read("serve.batch_device_ms", ctx) == 750.0
    assert _read("serve.dispatch_ms", ctx) == 43.0  # (32 + 54) / 2
    batches[1]["wait_ms"] = waits[1][:-1]
    with pytest.raises(ReadError, match="waits"):
        _read("serve.queue_wait_p95_ms", ctx)


@pytest.mark.parametrize("metric", ["serve.queue_wait_p95_ms", "serve.batch_device_ms", "serve.dispatch_ms"])
def test_serving_counters_read_nothing_on_the_cpu_or_from_an_older_program(metric):
    cpu = [_batch(0, [1.0], 1.0, 1.0, None), _batch(1, [2.0], 1.0, 1.0, None)]
    assert _read(metric, types.SimpleNamespace(batches=cpu)) is None
    older = [{"n": 1, "tier": 1, "steps": 50, "run_s": 0.5, "copy_ms": None}]
    assert _read(metric, types.SimpleNamespace(batches=older)) is None
    assert _read(metric, types.SimpleNamespace(batches=[])) is None
    mixed = [_batch(0, [1.0], 1.0, 1.0, 5.0), _batch(1, [2.0], 1.0, 1.0, None)]
    with pytest.raises(ReadError, match="device time"):
        _read(metric, types.SimpleNamespace(batches=mixed))


def _span(name, a, b, batch=0):
    return Span(name, "adt-batcher", int(a * 1e9), int(b * 1e9), {"batch": batch})


def test_idle_inside_the_worker_spans():
    from benchmark.core.spans import idle_queued_pct

    # window 100-110 s; the card busy 101-103 and 105-109: idle 100-101, 103-105, 109-110 (4 s, 40%)
    trace = Trace(device_ops=[Op("k", 101.0, 2.0), Op("k", 105.0, 4.0)], window=(100.0, 110.0))
    ctx = types.SimpleNamespace(trace=trace)
    spans = [_span("adt.serve.hold", 99.0, 100.5),  # clipped to the window: 0.5 s idle
             _span("adt.serve.assemble", 100.5, 100.75),  # 0.25 s idle
             _span("adt.serve.launch", 102.5, 103.5),  # 0.5 s idle (103-103.5)
             _span("adt.serve.backpressure", 104.0, 104.5, 1),  # 0.5 s idle
             _span("adt.serve.hold", 104.25, 104.75, 2),  # overlaps the last: 0.25 s more
             _span("something.else", 109.0, 110.0)]  # not the worker's
    assert idle_queued_pct(ctx, spans, 0) == pytest.approx(100.0 * 2.0 / 10.0)
    assert 100.0 * (1 - trace.busy_s / trace.window_s) == pytest.approx(40.0)  # device.idle_pct.serve, above it
    with pytest.raises(ReadError, match="let 3 spans go"):
        idle_queued_pct(ctx, spans, 3)
    with pytest.raises(ReadError, match="no span"):
        idle_queued_pct(ctx, spans[-1:], 0)
    assert idle_queued_pct(types.SimpleNamespace(trace=None), spans, 0) is None  # the CPU: no trace


def test_idle_queued_reader_reads_the_programs_buffer(monkeypatch):
    from audio_diffusion_torch.utils import profiling

    trace = Trace(device_ops=[Op("k", 101.0, 8.0)], window=(100.0, 110.0))
    monkeypatch.setattr(profiling, "spans", lambda: [_span("adt.serve.hold", 100.0, 101.0)], raising=False)
    monkeypatch.setattr(profiling, "dropped", lambda: 0, raising=False)
    assert _read("device.idle_queued_pct.serve", types.SimpleNamespace(trace=trace)) == pytest.approx(10.0)
    assert _read("device.idle_queued_pct.serve", types.SimpleNamespace(trace=None)) is None
