"""A stopped server's lifetime and the batcher's process-wide cuDNN window, on the CPU:

- with the cycle collector off, a started, used and stopped
  ``AudioDiffusionServer`` frees its pipeline by reference counting alone, as
  do a batcher that ran fused programs and a ``shard()``ed pipeline: on the
  card the pipeline holds its CUDA graphs and graph pool;
- ``utils.batch_invariant.window`` keeps cuDNN off while any window is open
  and puts back the flag it found once the last one closes, for every order
  in which two windows can open and close, and two ``DynamicBatcher``s on a
  (fake) CUDA device whose calls interleave see cuDNN off throughout.
"""

import gc
import http.client
import json
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.models import UNet2D, UNetConfig
from audio_diffusion_torch.parallel import make_mesh
from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig
from audio_diffusion_torch.serving import AudioDiffusionServer, DynamicBatcher
from audio_diffusion_torch.utils import batch_invariant

RES = 16


def _pipe():
    cfg = UNetConfig(sample_size=(RES, RES), block_out_channels=(8, 16),
                     down_block_types=("DownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "UpBlock2D"),
                     layers_per_block=1, norm_num_groups=4, fused_groupnorm=True)
    return AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(0)),
                                  Mel(x_res=RES, y_res=RES, hop_length=512, n_iter=8, device="cpu"),
                                  DDIMScheduler(SchedulerConfig(num_train_timesteps=100)), device="cpu")


@pytest.fixture
def no_collector():
    """The cycle collector off: what is freed is freed by reference counting."""
    gc.collect()
    gc.disable()
    yield
    gc.enable()


def _serve_one(pipe):
    server = AudioDiffusionServer(pipe, port=0, max_batch=2, max_wait_ms=10, steps=2)
    server.start()
    try:
        conn = http.client.HTTPConnection(*server.address[:2], timeout=120)
        conn.request("POST", "/generate", json.dumps({"seed": 3, "format": "json"}))
        resp = conn.getresponse()
        assert resp.status == 200 and len(json.loads(resp.read())["image"]) == RES
        conn.close()
    finally:
        server.stop()


def _batch_one(pipe):
    batcher = DynamicBatcher(pipe, max_batch=2, max_wait_ms=10, steps=2)
    try:
        batcher.warmup()
        assert batcher.submit(seed=3).result(timeout=120).image.shape == (RES, RES)
    finally:
        batcher.close()
    assert pipe._compiled, "the batcher ran the pipeline's fused programs"


def _shard_one(pipe):
    pipe.shard(make_mesh(devices=["cpu", "cpu"]))
    raw, _ = pipe(batch_size=2, steps=2, return_arrays=True)
    assert raw.shape == (2, RES, RES) and pipe._compiled
    _serve_one(pipe)


@pytest.mark.parametrize("use", [_serve_one, _batch_one, _shard_one], ids=["server", "batcher", "sharded"])
def test_a_stopped_server_frees_its_pipeline_without_the_collector(no_collector, use):
    pipe = _pipe()
    alive = weakref.ref(pipe)
    use(pipe)
    del pipe
    assert alive() is None, [type(r).__name__ for r in gc.get_referrers(alive())]


def test_a_server_never_started_stops_at_once(no_collector):
    """stop() of a server whose HTTP loop never ran drains the batcher and
    returns (socketserver's shutdown() would wait for a loop that never
    began), and the pipeline is freed as after a served one."""
    pipe = _pipe()
    alive = weakref.ref(pipe)
    server = AudioDiffusionServer(pipe, port=0, max_batch=2, max_wait_ms=10, steps=2)
    assert server.batcher.submit(seed=1).result(timeout=120).image.shape == (RES, RES)
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    stopper.join(timeout=60)
    assert not stopper.is_alive(), "stop() of a server never started did not return"
    del server, pipe, stopper
    assert alive() is None


# ------------------------------------------------------------------ the window

@pytest.fixture(params=[True, False], ids=["cudnn-on", "cudnn-off"])
def cudnn_before(request):
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = request.param
    yield request.param
    torch.backends.cudnn.enabled = saved


@pytest.mark.parametrize("closes", ["first-opened-first", "last-opened-first"])
def test_overlapping_windows_keep_cudnn_off_and_restore_it(cudnn_before, closes):
    """A opens, B opens, then they close in either order, each on its own
    thread: the flag is False while either is open and the prior value after."""
    a_open, b_open, a_close, b_close = (threading.Event() for _ in range(4))
    seen = {}

    def hold(name, opened, close):
        with batch_invariant.window():
            seen[name, "in"] = torch.backends.cudnn.enabled
            opened.set()
            close.wait(timeout=30)
            seen[name, "last"] = torch.backends.cudnn.enabled

    a = threading.Thread(target=hold, args=("A", a_open, a_close))
    a.start()
    a_open.wait(timeout=30)
    b = threading.Thread(target=hold, args=("B", b_open, b_close))
    b.start()
    b_open.wait(timeout=30)
    first, second = ((a, a_close), (b, b_close)) if closes == "first-opened-first" else ((b, b_close), (a, a_close))
    first[1].set()
    first[0].join(timeout=30)
    assert torch.backends.cudnn.enabled is False  # the other window is still open
    second[1].set()
    second[0].join(timeout=30)
    assert set(seen.values()) == {False}, seen
    assert torch.backends.cudnn.enabled is cudnn_before


def test_a_window_restores_the_flag_when_its_body_raises(cudnn_before):
    with pytest.raises(RuntimeError, match="inside"):
        with batch_invariant.window():
            raise RuntimeError("inside")
    assert torch.backends.cudnn.enabled is cudnn_before


class _FlagPipe:
    """A pipeline stand-in on a fake CUDA device: records the cuDNN flag when a
    batch starts and when it ends, blocking in between on ``release``."""

    device = "cuda"
    sample_hw = (4, 4)
    unet = types.SimpleNamespace(config=types.SimpleNamespace(in_channels=1, cross_attention_dim=None))
    mel = types.SimpleNamespace(x_res=4, hop_length=2, get_sample_rate=lambda: 22050)

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.flags = []

    def get_default_steps(self):
        return 2

    def __call__(self, noise, **kw):
        self.flags.append(torch.backends.cudnn.enabled)
        self.entered.set()
        self.release.wait(timeout=30)
        self.flags.append(torch.backends.cudnn.enabled)
        b = len(noise)
        return torch.zeros((b, 4, 4), dtype=torch.uint8), torch.zeros((b, 6))


def test_two_batchers_interleaving_keep_cudnn_off(monkeypatch, cudnn_before):
    """The order that broke a per-batcher save and restore: A opens (saves the
    flag), B opens (would save False), A closes (would restore the flag while
    B runs), B closes (would leave cuDNN off for good)."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)  # no card: the outputs are host tensors
    monkeypatch.setattr(DynamicBatcher, "_step_generators", lambda self, seeds: [None] * len(seeds))
    pipes = _FlagPipe(), _FlagPipe()
    batchers = [DynamicBatcher(p, max_batch=1, max_wait_ms=1) for p in pipes]
    try:
        fa = batchers[0].submit(seed=1)
        assert pipes[0].entered.wait(timeout=30)
        fb = batchers[1].submit(seed=2)
        assert pipes[1].entered.wait(timeout=30)
        pipes[0].release.set()
        fa.result(timeout=30)
        assert torch.backends.cudnn.enabled is False  # B's batch is still running
        pipes[1].release.set()
        fb.result(timeout=30)
    finally:
        for p in pipes:
            p.release.set()
        for b in batchers:
            b.close()
    assert pipes[0].flags == pipes[1].flags == [False, False]
    assert torch.backends.cudnn.enabled is cudnn_before
    assert isinstance(fa.result().image, np.ndarray)
