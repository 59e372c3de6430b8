"""The port's serving layer on the CPU, mirroring tests/test_serving.py:

- a request's spectrogram is bitwise the same solo and co-batched, for eta=0
  and for eta>0 (per-row step generators), and at 50 steps alone and in
  tiers 2, 4 and 8 on the tiny attention models;
- concurrent requests share one pipeline call; snap and pad tiers; settings
  groups never mix; undeclared settings are refused at submit;
- a cancelled future does not poison its batch; a failing batch reaches its
  callers and the worker keeps serving; QueueFull and per-group caps;
- HTTP end to end: wav and json, 429 with Retry-After, audio-to-audio;
- warmup calls the pipeline with every signature a live batch uses;
- the per-seed noise is bitwise the JAX package's;
- a conditional model: encoding requests share a batch (padding rows get zero
  encodings), a seed is bitwise the same solo and co-batched, the encoding
  checks hold, and JSON ``"encoding": [[...]]`` bodies over HTTP.
"""

import base64
import http.client
import io
import json
import threading
import time
import types
import wave

import numpy as np
import pytest
import torch

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig
from audio_diffusion_torch.serving import AudioDiffusionServer, DynamicBatcher, QueueFull, make_server
from audio_diffusion_torch.serving.__main__ import parse_args
from audio_diffusion_torch.serving.batcher import _noise_for_seed, copy_to_host_async
from audio_diffusion_torch.utils import profiling

RES = 16
HOP = 512


def _pipe():
    cfg = UNetConfig(sample_size=(RES, RES), block_out_channels=(8, 16),
                     down_block_types=("DownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "UpBlock2D"),
                     layers_per_block=1, norm_num_groups=4, fused_groupnorm=True)
    return AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(0)),
                                  Mel(x_res=RES, y_res=RES, hop_length=HOP, n_iter=8, device="cpu"),
                                  DDIMScheduler(SchedulerConfig(num_train_timesteps=100)), device="cpu")


@pytest.fixture(scope="module")
def pipe():
    return _pipe()


def _attention_pipe(dtype):
    """A tiny latent pipeline with the attention on the serving path: an
    AttnDownBlock2D/AttnUpBlock2D pair in the UNet and the VAE's mid attention."""
    vae = AutoencoderKL(VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4, sample_size=RES,
                                  dtype=dtype)).init_params(torch.Generator().manual_seed(2))
    cfg = UNetConfig(sample_size=vae.config.latent_hw(RES, RES), block_out_channels=(16, 32),
                     down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                     up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=8, dtype=dtype,
                     fused_groupnorm=True)
    return AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(3)),
                                  Mel(x_res=RES, y_res=RES, hop_length=HOP, n_iter=8, device="cpu"),
                                  DDIMScheduler(SchedulerConfig(num_train_timesteps=100)), vae, device="cpu")


@pytest.fixture(scope="module")
def attention_pipes():
    return {"attention-f32": _attention_pipe("float32"), "attention-bf16": _attention_pipe("bfloat16")}


CROSS = 8  # the tiny conditional model's cross_attention_dim


@pytest.fixture(scope="module")
def cond_pipe():
    cfg = UNetConfig(sample_size=(RES, RES), block_out_channels=(8, 16),
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, norm_num_groups=4,
                     attention_head_dim=4, cross_attention_dim=CROSS, fused_groupnorm=True)
    return AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(1)),
                                  Mel(x_res=RES, y_res=RES, hop_length=HOP, n_iter=8, device="cpu"),
                                  DDIMScheduler(SchedulerConfig(num_train_timesteps=100)), device="cpu")


def _encoding(seed):
    return np.random.default_rng(seed).standard_normal((1, CROSS)).astype(np.float32)


class CountingPipe:
    """Delegates to the real pipeline, recording every call's batch size."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.call_batches = []
        self.lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, **kw):
        with self.lock:
            self.call_batches.append(len(kw["noise"]))
        return self._pipe(**kw)


class FlakyPipe(CountingPipe):
    """Raises on the first pipeline call, then recovers."""

    def __call__(self, **kw):
        with self.lock:
            self.call_batches.append(len(kw["noise"]))
            first = len(self.call_batches) == 1
        if first:
            raise RuntimeError("injected device failure")
        return self._pipe(**kw)


class GatedPipe(CountingPipe):
    """Blocks every call until released; ``entered`` says a batch is in flight."""

    def __init__(self, pipe):
        super().__init__(pipe)
        self.release = threading.Event()
        self.entered = threading.Event()

    def __call__(self, **kw):
        self.entered.set()
        self.release.wait(timeout=120)
        return super().__call__(**kw)


class RecordingPipe(CountingPipe):
    """Records the signature of every call: what a batch hands the pipeline."""

    def __init__(self, pipe):
        super().__init__(pipe)
        self.signatures = []

    def __call__(self, **kw):
        def sig(v):
            if isinstance(v, (np.ndarray, torch.Tensor)):
                return ("array", tuple(v.shape), str(v.dtype))
            if isinstance(v, (list, tuple)):
                return (type(v).__name__, len(v), tuple(sorted({type(x).__name__ for x in v})))
            return v

        with self.lock:
            self.signatures.append(tuple(sorted((k, sig(v)) for k, v in kw.items())))
        return self._pipe(**kw)


def _solo(pipe, seed, steps, eta=0.0, raw_audio=None, start_step=0, encoding=None):
    noise = _noise_for_seed(seed, *pipe.sample_hw, pipe.unet.config.in_channels)[None]
    raw, _ = pipe(noise=noise, steps=steps, eta=eta,
                  step_generator=[torch.Generator().manual_seed(seed)], raw_audio=raw_audio,
                  start_step=start_step, encoding=None if encoding is None else encoding[None],
                  return_arrays=True)
    return raw.numpy()[0]


def test_noise_for_seed_is_bitwise_the_jax_packages():
    from audio_diffusion_tpu.serving.batcher import _noise_for_seed as jax_noise_for_seed

    for seed in (0, 7, 2**62 + 3):
        np.testing.assert_array_equal(_noise_for_seed(seed, RES, RES, 1), jax_noise_for_seed(seed, RES, RES, 1))


@pytest.mark.parametrize("model, eta", [pytest.param("plain", eta, id=str(eta)) for eta in (0.0, 1.0)]
                         + [pytest.param(m, eta, id=f"{m}-{eta}") for m in ("attention-f32", "attention-bf16")
                            for eta in (0.0, 1.0)])
def test_solo_equals_batched_bitwise(pipe, attention_pipes, model, eta):
    """Same seed -> bitwise the same spectrogram alone or padded into a tier
    with other requests; at eta > 0 because the step noise of each row comes
    from its own generator, seeded with its request's seed. The plain UNet has
    no attention; the attention models put SelfAttention2D and the VAE's mid
    attention on the path, in f32 and in bf16."""
    pipe = pipe if model == "plain" else attention_pipes[model]
    solo = _solo(pipe, 7, 3, eta)
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=500, steps=3, eta=eta)
    try:
        futs = [batcher.submit(seed=s) for s in (3, 7, 11)]  # pads to tier 4
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    np.testing.assert_array_equal(results[1].image, solo)
    assert results[0].image.dtype == np.uint8 and results[0].sample_rate == 22050
    assert not np.array_equal(results[0].image, results[1].image), "seeds must differ"
    assert np.isfinite(results[0].audio).all() and len(results[0].audio) == (RES - 1) * HOP
    if eta:
        assert not np.array_equal(solo, _solo(pipe, 7, 3, 0.0)), "eta > 0 must draw step noise"


@pytest.mark.parametrize("model", ["attention-f32", "attention-bf16"])
def test_lone_row_matches_every_tier_at_50_steps(attention_pipes, model, one_thread):
    """The serving contract at the depth users serve: seed 7 at 50 DDIM
    steps, eta 0, alone (tier 1) and padded into tiers 2, 4 and 8 through
    ``DynamicBatcher`` with other seeds, gives one uint8 spectrogram. On the
    CPU torch's convolutions take another kernel for a lone row, so the
    float result is not the batched row's: row 0's final latents against
    tier 1, as this test prints them (torch 2.13 on the CPU), differ by at
    most 9.2e-06 (f32) and 6.6e-07 (bf16) at every tier. The contract is
    stated on the spectrogram, and there it holds. One intra-op thread keeps
    the test at a few seconds beside other test processes."""
    pipe = attention_pipes[model]
    companions = {1: (), 2: (3,), 4: (3, 11), 8: (3, 11, 13, 17)}  # padded to the tier
    batcher = DynamicBatcher(pipe, max_batch=8, max_wait_ms=200, steps=50, batch_policy="pad")
    try:
        images = {}
        for tier, others in companions.items():
            futs = [batcher.submit(seed=s) for s in (7, *others)]
            images[tier] = [f.result(timeout=120) for f in futs][0].image
        assert [s["tier"] for s in batcher.stats] == list(companions)
    finally:
        batcher.close()
    for tier in (2, 4, 8):
        np.testing.assert_array_equal(images[tier], images[1])

    h, w = pipe.sample_hw
    schedule = pipe.scheduler.schedule(50)
    latents = {}
    for tier, others in companions.items():
        noise = np.zeros((tier, h, w, 1), np.float32)
        for i, seed in enumerate((7, *others)):
            noise[i] = _noise_for_seed(seed, h, w, 1)
        x = torch.from_numpy(noise)
        with torch.inference_mode():
            latents[tier] = pipe._denoise(x, x, x, None, schedule, schedule.timesteps, 0.0, None, None)[0]
    drift = {tier: (latents[tier] - latents[1]).abs().max().item() for tier in (2, 4, 8)}
    print(f"{model}: row 0's final latents at 50 steps against tier 1, max abs difference by tier: {drift}")
    assert all(np.isfinite(d) for d in drift.values())


def test_concurrent_requests_share_one_batch(pipe):
    counting = CountingPipe(pipe)
    batcher = DynamicBatcher(counting, max_batch=4, max_wait_ms=1500, steps=2)
    try:
        batcher.submit(seed=0).result(timeout=120)
        futs = [batcher.submit(seed=s) for s in range(4)]
        for f in futs:
            f.result(timeout=120)
    finally:
        batcher.close()
    assert counting.call_batches == [1, 4], counting.call_batches


@pytest.mark.parametrize("policy, n, batches, fill", [("snap", 7, [4, 2, 1], 1.0), ("pad", 3, [4], 0.75)])
def test_batch_policy_tiers(pipe, policy, n, batches, fill):
    """snap: every dispatched batch is exactly a tier <= queue depth (7 ship
    as 4+2+1, no padding); pad: everything queued ships padded to the next tier."""
    counting = CountingPipe(pipe)
    batcher = DynamicBatcher(counting, max_batch=8, max_wait_ms=1500, steps=2, batch_policy=policy)
    try:
        futs = [batcher.submit(seed=s) for s in range(n)]
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert counting.call_batches == batches, counting.call_batches
    assert all(r.image.shape == (RES, RES) for r in results)
    assert batcher.latency_summary()["fill"] == fill
    with pytest.raises(ValueError, match="batch_policy"):
        DynamicBatcher(pipe, max_batch=2, batch_policy="nope").close()


@pytest.mark.parametrize("second, calls", [({"steps": 3}, [1, 1]), ({"steps": 2}, [2])])
def test_settings_groups(pipe, second, calls):
    """Different steps never share a batch; the explicit default and steps
    omitted are one group."""
    counting = CountingPipe(pipe)
    batcher = DynamicBatcher(counting, max_batch=4, max_wait_ms=500, steps=2, allowed_steps=(3,))
    try:
        futs = [batcher.submit(seed=0), batcher.submit(seed=1, **second)]
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert counting.call_batches == calls, counting.call_batches
    assert not np.array_equal(results[0].image, results[1].image)


def test_undeclared_settings_rejected_at_submit(pipe):
    batcher = DynamicBatcher(pipe, max_batch=2, steps=2)
    try:
        with pytest.raises(ValueError, match="allow_steps"):
            batcher.submit(steps=41)
        with pytest.raises(ValueError, match="allowed_etas"):
            batcher.submit(eta=0.7)
        with pytest.raises(ValueError, match="seed"):
            batcher.submit(seed=-1)
        with pytest.raises(ValueError, match="unconditional"):
            batcher.submit(encoding=np.zeros((1, 8), np.float32))
        with pytest.raises(ValueError, match="start_step=1 is not served"):
            batcher.submit(audio=np.zeros(10, np.float32), start_step=1)
        with pytest.raises(ValueError, match="nothing to re-noise"):
            batcher.submit(start_step=1)
        assert batcher.submit(seed=1).result(timeout=120).image.shape == (RES, RES)
    finally:
        batcher.close()


def test_submit_validates_encoding_shape(pipe):
    """The conditional checks keep the JAX package's messages (the port's
    UNet is unconditional, so a stand-in config says the model is conditional)."""
    cond = CountingPipe(pipe)
    cond.unet = types.SimpleNamespace(config=types.SimpleNamespace(cross_attention_dim=8))
    batcher = DynamicBatcher(cond, max_batch=2, max_wait_ms=10, steps=2)
    try:
        with pytest.raises(ValueError, match="cross_attention_dim=8"):
            batcher.submit(encoding=np.zeros((1, 5), np.float32))
        with pytest.raises(ValueError, match="seq length"):
            batcher.submit(encoding=np.zeros((3, 8), np.float32))
        with pytest.raises(ValueError, match="encoding= is required"):
            batcher.submit(seed=0)
    finally:
        batcher.close()


def test_cancelled_future_does_not_poison_the_batch(pipe):
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=1000, steps=2)
    try:
        f1 = batcher.submit(seed=0)
        f2 = batcher.submit(seed=1)
        assert f1.cancel()
        assert f2.result(timeout=120).image.shape == (RES, RES)
        assert f1.cancelled()
    finally:
        batcher.close()


def test_batch_failure_propagates_and_worker_survives(pipe):
    batcher = DynamicBatcher(FlakyPipe(pipe), max_batch=2, max_wait_ms=10, steps=2)
    try:
        with pytest.raises(RuntimeError, match="injected device failure"):
            batcher.submit(seed=0).result(timeout=120)
        assert batcher.submit(seed=1).result(timeout=120).image.shape == (RES, RES)
    finally:
        batcher.close()


@pytest.mark.parametrize("cap", ["global", "group"])
def test_overload_sheds_with_queue_full(pipe, cap):
    """With the worker busy: the global cap sheds with QueueFull and a retry
    estimate; a full settings group does not block other groups. Every
    accepted request still resolves."""
    gated = GatedPipe(pipe)
    kw = dict(max_queue=4) if cap == "global" else dict(max_queue=8, max_group_queue=2, allowed_steps=(3,))
    batcher = DynamicBatcher(gated, max_batch=1, max_wait_ms=5, steps=2, **kw)
    try:
        first = batcher.submit(seed=0)
        assert gated.entered.wait(timeout=60)
        accepted = [batcher.submit(seed=s) for s in range(1, 5 if cap == "global" else 3)]
        with pytest.raises(QueueFull, match="over capacity" if cap == "global" else "settings-group") as exc:
            batcher.submit(seed=99)
        assert 1.0 <= exc.value.retry_after_s <= 60.0 and batcher.requests_shed == 1
        if cap == "global":
            assert batcher.latency_summary()["queued"] == 4
        else:
            accepted.append(batcher.submit(seed=4, steps=3))  # another group: admitted
        gated.release.set()
        for f in [first] + accepted:
            assert f.result(timeout=120).image.dtype == np.uint8
        assert batcher.submit(seed=100).result(timeout=120).image.dtype == np.uint8
    finally:
        gated.release.set()
        batcher.close()


def test_audio_to_audio_serving(pipe):
    """Each request's clip conditions its own output, bitwise a direct call
    with the same noise and clip (padding rows do not perturb real rows)."""
    clips = (np.random.default_rng(0).standard_normal((2, RES * HOP)) * 0.1).astype(np.float32)
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=500, steps=4, allowed_start_steps=(2,))
    try:
        futs = [batcher.submit(seed=s, audio=clips[s], start_step=2) for s in (0, 1)]
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    for i in (0, 1):
        np.testing.assert_array_equal(results[i].image, _solo(pipe, i, 4, raw_audio=clips[i:i + 1], start_step=2))
    assert not np.array_equal(results[0].image, results[1].image)


def test_warmup_covers_live_batch_signatures(pipe):
    """After warmup(), a live batch calls the pipeline only with argument
    signatures warmup already used (shapes, dtypes, per-row generators)."""
    rec = RecordingPipe(pipe)
    batcher = DynamicBatcher(rec, max_batch=2, max_wait_ms=200, steps=2, allowed_etas=(1.0,),
                             allowed_start_steps=(1,))
    try:
        batcher.warmup()
        warmed = set(rec.signatures)
        assert len(warmed) == 2 * 2 * 2  # tiers x etas x (generation, audio-to-audio)
        futs = [batcher.submit(seed=1), batcher.submit(seed=2, eta=1.0),
                batcher.submit(seed=3, audio=np.zeros(100, np.float32), start_step=1)]
        for f in futs:
            f.result(timeout=120)
    finally:
        batcher.close()
    live = set(rec.signatures[len(warmed):])
    assert live and live <= warmed, live - warmed


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many tiny batches: the fastest for
    them, and the test keeps its time when other test processes load every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_warmup_covers_live_batch_programs(one_thread):
    """The counterpart of tests/test_serving.py::test_warmup_covers_live_batch_programs:
    after warmup(), live batches run only fused programs warmup already made
    (on the card, captured), so no capture happens inside the serving window.
    A fresh pipeline, so the cache accounting is exact."""
    fresh = _pipe()
    batcher = DynamicBatcher(fresh, max_batch=4, max_wait_ms=50, steps=3, allowed_etas=(1.0,))
    try:
        batcher.warmup()
        warmed = set(fresh._compiled)
        assert len(warmed) == len(batcher.tiers) * 2  # tiers x etas
        futs = [batcher.submit(seed=s) for s in (1, 2, 3)] + [batcher.submit(seed=4, eta=1.0)]
        for f in futs:
            f.result(timeout=120)
    finally:
        batcher.close()
    new = set(fresh._compiled) - warmed
    assert not new, f"live batches made programs warmup missed: {sorted(map(str, new))}"


def test_stats_split_each_rows_latency_and_no_span_without_a_profiler(pipe):
    """Every batch's entry carries its sequence number, one wait per row, the
    assembly and launch times and, on the CPU, no device time; a row's wait +
    assembly + run is its submit-to-result latency. No profiler runs, so the
    worker records no span."""
    from audio_diffusion_torch.utils import profiling

    before = profiling.spans()
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=50, steps=2)
    try:
        futs = [batcher.submit(seed=s) for s in range(3)]
        for f in futs:
            f.result(timeout=120)
        futs = [batcher.submit(seed=s) for s in range(2)]
        for f in futs:
            f.result(timeout=120)
    finally:
        batcher.close()
    stats, lats = list(batcher.stats), list(batcher._latencies)
    assert profiling.spans() == before
    assert [s["batch"] for s in stats] == sorted({s["batch"] for s in stats}) and sum(s["n"] for s in stats) == 5
    k = 0
    for s in stats:
        assert len(s["wait_ms"]) == s["n"] and s["device_ms"] is None
        assert s["assemble_ms"] >= 0 and s["launch_ms"] >= 0 and 1e3 * s["run_s"] >= s["launch_ms"] - 0.1
        for w in s["wait_ms"]:
            assert abs((w + s["assemble_ms"]) / 1e3 + s["run_s"] - lats[k]) < 1e-3
            k += 1
    assert k == len(lats) == 5


def test_worker_spans_under_a_profiler_on_the_main_thread(pipe):
    """With ``torch.profiler.profile`` started on this thread, the worker
    records hold, assemble and launch for every batch from its own thread,
    each with its batch number, and backpressure where the finisher is held
    back (its queue full: here, the stats lock held)."""
    mark = len(profiling.spans())
    batcher = DynamicBatcher(pipe, max_batch=1, max_wait_ms=0, steps=2)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with batcher._stats_lock:  # the finisher stops at its first batch's entry
                futs = [batcher.submit(seed=s) for s in range(4)]
                deadline = time.monotonic() + 120
                # until the fourth batch's hand-over waits on the full queue
                while not batcher._finish_q.not_full._waiters and time.monotonic() < deadline:
                    time.sleep(0.01)
                released = time.time_ns()
            for f in futs:
                f.result(timeout=120)
    finally:
        batcher.close()
    got = [s for s in profiling.spans()[mark:] if s.name.startswith("adt.serve.")]
    assert {s.thread for s in got} == {"adt-batcher"}
    for b in range(4):
        mine = [s for s in got if s.ids == {"batch": b}]
        names = [s.name for s in mine]
        assert names[:3] == ["adt.serve.hold", "adt.serve.assemble", "adt.serve.launch"], names
        assert all(a.t1_ns <= c.t0_ns for a, c in zip(mine, mine[1:]))
    back = [s for s in got if s.name == "adt.serve.backpressure"]
    assert [s.ids["batch"] for s in back] == [3] and back[0].t0_ns < released <= back[0].t1_ns


def test_finisher_copy_on_the_cpu_is_the_plain_path():
    x = torch.arange(6).reshape(2, 3)
    hosts, events = copy_to_host_async((x, x + 1), None)
    assert events is None and hosts[0] is x and torch.equal(hosts[1], x + 1)


def _post(host, port, body, timeout=300):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", "/generate", body if isinstance(body, str) else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_http_server_end_to_end(pipe):
    """Concurrent wav requests, json, /healthz, audio-to-audio, a 400, and
    the wav container holding the same int16 samples as the json PCM."""
    server = AudioDiffusionServer(pipe, port=0, max_batch=4, max_wait_ms=100, steps=4, allowed_start_steps=(2,))
    server.start()
    host, port = server.address[:2]
    try:
        results = {}
        threads = [threading.Thread(target=lambda s=s: results.__setitem__(s, _post(host, port, {"seed": s})))
                   for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for resp, data in results.values():
            assert resp.status == 200 and resp.getheader("Content-Type") == "audio/wav"
            with wave.open(io.BytesIO(data)) as w:
                assert w.getframerate() == 22050 and w.getnframes() == (RES - 1) * HOP
        assert results[1][1] != results[2][1], "different seeds -> different audio"

        resp_wav, wav_data = _post(host, port, {"seed": 12})
        resp_json, json_data = _post(host, port, {"seed": 12, "format": "json"})
        assert resp_wav.status == resp_json.status == 200
        payload = json.loads(json_data)
        assert np.asarray(payload["image"], dtype=np.uint8).shape == (RES, RES)
        with wave.open(io.BytesIO(wav_data)) as w:
            assert w.readframes(w.getnframes()) == base64.b64decode(payload["pcm16_base64"])

        clip = (np.sin(np.arange(RES * HOP) * 0.05) * 20000).astype(np.int16)
        resp, data = _post(host, port, {"seed": 3, "start_step": 2,
                                        "audio_pcm16_base64": base64.b64encode(clip.tobytes()).decode()})
        assert resp.status == 200
        with wave.open(io.BytesIO(data)) as w:
            assert w.getnframes() == (RES - 1) * HOP

        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["status"] == "ok" and health["batches_run"] >= 3 and health["tiers"] == [1, 2, 4]
        assert "mean_copy_ms" not in health  # the copies are timed on the card only

        for bad in ({"encoding": "not-an-array"}, [1, 2, 3], {"steps": 41}):
            resp, data = _post(host, port, bad)
            assert resp.status == 400, data
    finally:
        server.stop()


def test_http_429_with_retry_after(pipe):
    gated = GatedPipe(pipe)
    server = AudioDiffusionServer(gated, port=0, max_batch=1, max_wait_ms=5, steps=2, max_queue=2)
    server.start()
    host, port = server.address[:2]
    try:
        results = {}

        def client(s):
            results[s] = _post(host, port, {"seed": s}, timeout=120)

        threads = [threading.Thread(target=client, args=(1,))]
        threads[0].start()
        assert gated.entered.wait(timeout=60)
        threads += [threading.Thread(target=client, args=(s,)) for s in (2, 3)]
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and server.batcher.latency_summary().get("queued", 0) < 2:
            time.sleep(0.02)
        t0 = time.monotonic()
        resp, data = _post(host, port, {"seed": 99}, timeout=30)
        assert resp.status == 429 and int(resp.getheader("Retry-After")) >= 1
        assert json.loads(data)["retry_after_s"] >= 1 and time.monotonic() - t0 < 5.0
        gated.release.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert all(r.status == 200 for r, _ in results.values())
    finally:
        gated.release.set()
        server.stop()


def test_http_500_when_the_batch_fails_and_503_while_draining(pipe):
    server = AudioDiffusionServer(FlakyPipe(pipe), port=0, max_batch=1, max_wait_ms=5, steps=2)
    server.start()
    host, port = server.address[:2]
    try:
        resp, data = _post(host, port, {"seed": 0})
        assert resp.status == 500 and b"injected device failure" in data
        assert _post(host, port, {"seed": 1})[0].status == 200  # the worker kept serving
        server.batcher.close()  # draining: the batcher refuses new work, HTTP still answers
        resp, data = _post(host, port, {"seed": 2})
        assert resp.status == 503 and b"closed" in data
    finally:
        server.stop()


def test_concurrent_submitters_stress(pipe):
    """More submitting threads than cores, with a short switch interval: every
    accepted request resolves exactly once and the counters add up."""
    import sys

    n_threads, per_thread = 16, 3
    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=20, steps=1, max_queue=n_threads * per_thread)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    futs, lock = [], threading.Lock()

    def submitter(i):
        for j in range(per_thread):
            f = batcher.submit(seed=i * per_thread + j)
            with lock:
                futs.append(f)

    try:
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        results = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert len(results) == n_threads * per_thread and all(r.image.shape == (RES, RES) for r in results)
    assert batcher.requests_served == len(results) == sum(s["n"] for s in batcher.stats)
    assert batcher.latency_summary()["queued"] == 0


def test_make_server_loads_a_saved_pipeline(pipe, tmp_path, monkeypatch):
    pipe.save_pretrained(str(tmp_path))
    server = make_server(str(tmp_path), dtype="float32", fused_groupnorm=True, device="cpu", port=0,
                         max_batch=2, steps=2)
    assert server.batcher.pipe.unet.config.fused_groupnorm and server.batcher.pipe.device.type == "cpu"
    server.start()
    try:
        resp, data = _post(*server.address[:2], {"seed": 5, "format": "json"})
        assert resp.status == 200
        np.testing.assert_array_equal(np.asarray(json.loads(data)["image"], dtype=np.uint8), _solo(pipe, 5, 2))
    finally:
        server.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_server(str(tmp_path))  # the default device is the card


def test_serve_cli_parser():
    a = parse_args(["--model", "m", "--max_batch", "32", "--dtype", "bfloat16", "--fused_groupnorm",
                    "--no-warmup", "--allow_etas", "0.5", "--allow_start_steps", "25"])
    assert a.max_batch == 32 and a.dtype == "bfloat16" and a.fused_groupnorm is True and a.warmup is False
    assert a.device == "cuda" and a.allow_etas == [0.5] and a.allow_start_steps == [25]
    assert parse_args(["--model", "m"]).fused_groupnorm is None


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_conditional_requests_share_a_batch_and_match_solo(cond_pipe, eta):
    """Three encoded requests ride one tier-4 call under the pad policy (the
    padding row gets a zero encoding); each is bitwise its solo call with the
    same seed and encoding, and the same seed with another encoding gives
    another spectrogram."""
    counting = CountingPipe(cond_pipe)
    batcher = DynamicBatcher(counting, max_batch=4, max_wait_ms=1500, steps=3, eta=eta, batch_policy="pad")
    try:
        futs = [batcher.submit(seed=s, encoding=_encoding(e)) for s, e in ((3, 3), (7, 7), (7, 8))]
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert counting.call_batches == [4]
    np.testing.assert_array_equal(results[1].image, _solo(cond_pipe, 7, 3, eta, encoding=_encoding(7)))
    assert not np.array_equal(results[1].image, results[2].image), "the encoding must condition the output"


def test_submit_validates_encoding_on_a_conditional_model(cond_pipe):
    batcher = DynamicBatcher(cond_pipe, max_batch=2, max_wait_ms=10, steps=2)
    try:
        with pytest.raises(ValueError, match=f"cross_attention_dim={CROSS}"):
            batcher.submit(encoding=np.zeros((1, 5), np.float32))
        with pytest.raises(ValueError, match="seq length"):
            batcher.submit(encoding=np.zeros((3, CROSS), np.float32))
        with pytest.raises(ValueError, match="encoding= is required"):
            batcher.submit(seed=0)
        one_d = batcher.submit(seed=4, encoding=_encoding(4)[0]).result(timeout=120)  # (dim,) is a length-1 sequence
        np.testing.assert_array_equal(one_d.image, _solo(cond_pipe, 4, 2, encoding=_encoding(4)))
    finally:
        batcher.close()


def test_http_conditional_json_encodings(cond_pipe):
    """Concurrent JSON bodies with ``"encoding": [[...]]`` after a warmup: one
    batch, each image its solo call's; a wrong width answers 400."""
    counting = CountingPipe(cond_pipe)
    server = AudioDiffusionServer(counting, port=0, max_batch=2, max_wait_ms=1000, steps=2)
    server.batcher.warmup()
    warm = len(counting.call_batches)
    server.start()
    host, port = server.address[:2]
    try:
        results = {}
        threads = [threading.Thread(target=lambda s=s: results.__setitem__(s, _post(
            host, port, {"seed": s, "encoding": _encoding(s).tolist(), "format": "json"}))) for s in (5, 6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert counting.call_batches[warm:] == [2]
        for s, (resp, data) in results.items():
            assert resp.status == 200
            np.testing.assert_array_equal(np.asarray(json.loads(data)["image"], dtype=np.uint8),
                                          _solo(cond_pipe, s, 2, encoding=_encoding(s)))
        resp, data = _post(host, port, {"seed": 1, "encoding": [[0.0] * (CROSS + 1)]})
        assert resp.status == 400 and b"cross_attention_dim" in data
    finally:
        server.stop()


# ------------------------------------------------------------ sharded serving (tests/test_serving.py:346-391, 603-631)

def _sharded_pipe(n=2):
    """The ``pipe`` fixture's model (same seed, same weights) split over ``n`` shares of the CPU."""
    from audio_diffusion_torch.parallel import make_mesh

    return _pipe().shard(make_mesh(devices=["cpu"] * n))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sharded_batcher_over_mesh(pipe, eta):
    """Over a 2-way data axis the tiers are multiples of 2, and a request's
    spectrogram stays bitwise its unsharded solo run (the per-request noise
    and per-row step generators survive the split)."""
    solo = _solo(pipe, 7, 3, eta)
    sharded = _sharded_pipe()
    with pytest.raises(ValueError, match="multiple of the mesh"):
        DynamicBatcher(sharded, max_batch=3)
    batcher = DynamicBatcher(sharded, max_batch=8, max_wait_ms=200, steps=3, eta=eta)
    assert batcher.tiers == (2, 4, 8)
    try:
        futs = [batcher.submit(seed=s) for s in (3, 7, 11)]  # pads to tier 4
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    np.testing.assert_array_equal(results[1].image, solo)
    assert {s["tier"] for s in batcher.stats} <= {2, 4}


def test_sharded_audio_to_audio_over_mesh(pipe):
    """Audio-to-audio requests over the mesh: each clip splits with its row,
    bitwise the unsharded batched call."""
    full = RES * HOP
    clips = (np.random.default_rng(3).standard_normal((2, full)) * 0.1).astype(np.float32)
    noise = np.stack([_noise_for_seed(s, RES, RES, 1) for s in (0, 1)])
    direct = pipe(raw_audio=clips, noise=noise, start_step=2, steps=4, return_arrays=True)[0].numpy()
    batcher = DynamicBatcher(_sharded_pipe(), max_batch=4, max_wait_ms=300, steps=4, allowed_start_steps=(2,))
    try:
        futs = [batcher.submit(seed=s, audio=clips[s], start_step=2) for s in (0, 1)]
        results = [f.result(timeout=180) for f in futs]
    finally:
        batcher.close()
    for i in (0, 1):
        np.testing.assert_array_equal(results[i].image, direct[i])


def test_make_server_mesh_data_and_cli(pipe, tmp_path):
    pipe.save_pretrained(str(tmp_path))
    server = make_server(str(tmp_path), fused_groupnorm=True, device="cpu", mesh_data=2, port=0, max_batch=4,
                         steps=2)
    sharded = server.batcher.pipe
    assert dict(sharded.mesh.shape) == {"data": 2, "model": 1} and server.batcher.tiers == (2, 4)
    server.start()
    try:
        resp, data = _post(*server.address[:2], {"seed": 5, "format": "json"})
        assert resp.status == 200
        np.testing.assert_array_equal(np.asarray(json.loads(data)["image"], dtype=np.uint8), _solo(pipe, 5, 2))
    finally:
        server.stop()
    with pytest.raises(ValueError, match="multiple of the mesh"):
        make_server(str(tmp_path), device="cpu", mesh_data=2, max_batch=3)
    assert parse_args(["--model", "m", "--mesh_data", "4"]).mesh_data == 4
    assert parse_args(["--model", "m"]).mesh_data is None
