"""Port parity of UNet training, continued from test_torch_training.py (its
tiny configs and helpers): the data stream's epoch order against the JAX
package, checkpoints, ``run_training`` with a bitwise resume, with
encodings and with ``remat`` from the pretrained config, and the training
CLI, on the CPU."""

import gc
import json
import os
import shutil
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.checkpoint import checkpoint
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_training import COND_KW, RES, UNCOND_KW, _unet_pair

from audio_diffusion_torch.data import dataset as tdata
from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import unet2d
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_torch.training import checkpoint as tckpt
from audio_diffusion_torch.training import train_unet as tt
from audio_diffusion_torch.training.loop import RunConfig, run_training
from audio_diffusion_tpu.data import dataset as jdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------------ data

@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("slices")
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (RES, RES), dtype=np.uint8)).save(d / f"slice_{i:02d}.png")
    return str(d)


@pytest.mark.parametrize("precomputed", [False, True])
def test_epoch_batches_order_matches_jax(dataset_dir, precomputed):
    tds, jds = tdata.ImageSliceDataset(dataset_dir), jdata.ImageSliceDataset(dataset_dir)
    pre = None
    if precomputed:
        pre = (np.arange(8 * 4 * 4 * 2, dtype=np.float32).reshape(8, 4, 4, 2), [f"f{i}" for i in range(8)])
    for start in (0, 1):
        got = list(tdata.epoch_batches(tds, 2, 2, tdata.epoch_rng(3, 1), precomputed=pre, start_group=start))
        want = list(jdata.epoch_batches(jds, 2, 2, jdata.epoch_rng(3, 1), precomputed=pre, start_group=start))
        assert len(got) == len(want) == 2 - start
        for (a, _), (b, _) in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dataset_hf_path_needs_datasets_and_prefetch_reraises(tmp_path, monkeypatch):
    (tmp_path / "dataset_info.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        tdata.ImageSliceDataset(str(tmp_path))

    def broken():
        yield 1
        raise KeyError("boom")

    it = tdata.prefetch(broken(), transform=lambda x: x + 1)
    assert next(it) == 2
    with pytest.raises(KeyError):
        next(it)


# ------------------------------------------------------- checkpoints and the loop

def test_checkpoint_round_trip_and_pruning(tmp_path):
    _, _, _, port = _unet_pair(UNCOND_KW, seed=10)
    cfg = tt.TrainConfig()
    state = tt.init_train_state(cfg, port)
    step = tt.make_train_step(cfg, port, TorchDDPM())
    images = np.random.default_rng(11).uniform(-1, 1, (1, 2, 8, 8, 1)).astype(np.float32)
    manager = tckpt.make_manager(str(tmp_path / "ck"), max_to_keep=2)
    for _ in range(3):
        state, _ = step(state, images)
        tckpt.save_train_state(manager, state.step, state)
    assert manager.all_steps() == [2, 3] and not any(n.endswith(".tmp") for n in os.listdir(manager.directory))
    fresh = TorchUNet(port.config)
    template = tt.init_train_state(cfg, fresh)
    assert tckpt.restore_train_state(manager, template) is template
    assert template.step == 3 and template.opt_state.count == 3
    for a, b in ((template.params, state.params), (template.opt_state.mu, state.opt_state.mu),
                 (template.opt_state.nu, state.opt_state.nu), (template.ema_params, state.ema_params)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(p, state.params[k]) for k, p in fresh.named_parameters())  # restored in place
    assert tckpt.restore_train_state(tckpt.make_manager(str(tmp_path / "empty")), template) is None


def test_a_train_step_leaves_its_model_to_reference_counting():
    """With the cycle collector off, a UNet trained by make_train_step's step
    is freed once the caller drops the model, the state and the step: on the
    card a cycle through the step would keep the model and its gradients
    allocated until the collector ran."""
    gc.collect()
    gc.disable()
    try:
        unet = TorchUNet(TorchUNetConfig(**UNCOND_KW)).init_params(torch.Generator().manual_seed(0))
        alive = weakref.ref(unet)
        cfg = tt.TrainConfig(lr_warmup_steps=0)
        state = tt.init_train_state(cfg, unet)
        step = tt.make_train_step(cfg, unet, TorchDDPM())
        state, metrics = step(state, torch.rand((1, 2, 8, 8, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1)
        assert bool(torch.isfinite(metrics["loss"]))
        del unet, state, step, metrics
        assert alive() is None
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def seed_pipeline(tmp_path_factory):
    """A tiny port pipeline in the diffusers layout: --from_pretrained keeps the UNet tiny."""
    d = str(tmp_path_factory.mktemp("seed"))
    unet = TorchUNet(TorchUNetConfig(**dict(UNCOND_KW, sample_size=(RES, RES))))
    unet.init_params(torch.Generator().manual_seed(0))
    TorchPipeline(unet, TorchMel(x_res=RES, y_res=RES, device="cpu"), TorchDDIM(TorchSchedulerConfig(100)),
                  device="cpu").save_pretrained(d)
    return d


def _run(dataset_dir, seed_pipeline, out, max_steps, **kw):
    run = RunConfig(dataset=dataset_dir, output_dir=out, num_epochs=3, train_batch_size=2, save_images_epochs=1000,
                    save_model_epochs=1, scheduler="ddim", num_train_steps=100, from_pretrained=seed_pipeline,
                    max_steps=max_steps, log_every=1, device="cpu", **kw)
    return run_training(run, tt.TrainConfig(lr_warmup_steps=2, learning_rate=1e-3))


def test_run_training_resumes_bitwise_and_saves_a_loadable_pipeline(dataset_dir, seed_pipeline, tmp_path):
    """4 straight steps == 2 steps + a resumed 2 (mid-epoch: 4 steps per
    epoch), bitwise under deterministic algorithms; the saved directory loads
    in the port and in the JAX package."""
    from audio_diffusion_tpu.pipelines import AudioDiffusionPipeline

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        straight = _run(dataset_dir, seed_pipeline, str(tmp_path / "a"), 4)
        first = _run(dataset_dir, seed_pipeline, str(tmp_path / "b"), 2)
        resumed = _run(dataset_dir, seed_pipeline, str(tmp_path / "b"), 4)
        again = _run(dataset_dir, seed_pipeline, str(tmp_path / "b"), 4)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert straight["steps"] == resumed["steps"] == 4 and first["steps"] == 2
    assert straight["losses"] == first["losses"] + resumed["losses"] and np.isfinite(straight["losses"]).all()
    assert again["steps"] == 4 and again["losses"] == []  # already at max_steps: nothing trained
    ck = [tckpt.make_manager(str(tmp_path / d / "checkpoints")).restore() for d in ("a", "b")]
    for part in ("params", "ema_params"):
        assert all(torch.equal(ck[0][part][k], ck[1][part][k]) for k in ck[0][part])
    assert all(torch.equal(ck[0]["opt_state"][m][k], ck[1]["opt_state"][m][k])
               for m in ("mu", "nu") for k in ck[0]["params"])

    out = str(tmp_path / "a")
    pipe = TorchPipeline.from_pretrained(out, device="cpu")
    ema = ck[0]["ema_params"]
    assert all(torch.equal(p, ema[k]) for k, p in pipe.unet.named_parameters())  # saved from the EMA
    assert pipe(batch_size=1, steps=2, return_images_only=True).shape == (1, RES, RES)
    jpipe = AudioDiffusionPipeline.from_pretrained(out)
    assert jpipe(batch_size=1, steps=2, return_images_only=True).shape == (1, RES, RES)


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_run_training_takes_remat_from_the_pretrained_config(dataset_dir, seed_pipeline, tmp_path, monkeypatch,
                                                              mixed_precision):
    """``remat`` is set through the pipeline's ``unet/config.json``, as the
    JAX trainer reads it: the UNet then checkpoints its 12 blocks in every
    forward (also after the bf16 rebuild), the losses are bitwise those of
    the same run without it, and the saved pipeline keeps the flag for both
    packages."""
    from audio_diffusion_tpu.models import UNetConfig

    remat_seed = tmp_path / "remat_seed"
    shutil.copytree(seed_pipeline, remat_seed)
    config = json.loads((remat_seed / "unet" / "config.json").read_text())
    (remat_seed / "unet" / "config.json").write_text(json.dumps({**config, "remat": True}))
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(unet2d, "checkpoint", counted)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        plain = _run(dataset_dir, seed_pipeline, str(tmp_path / "plain"), 2, mixed_precision=mixed_precision)
        assert calls == []
        remat = _run(dataset_dir, str(remat_seed), str(tmp_path / "remat"), 2, mixed_precision=mixed_precision)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert len(calls) == 12 * 2 and remat["losses"] == plain["losses"]
    saved = str(tmp_path / "remat" / "unet")
    assert UNetConfig.from_pretrained(saved).remat and TorchPipeline.from_pretrained(
        str(tmp_path / "remat"), device="cpu").unet.config.remat


def test_run_training_frees_the_loaded_unet_it_rebuilds_in_bf16(dataset_dir, seed_pipeline, tmp_path, monkeypatch):
    """With --mixed_precision bf16 the trainer rebuilds the UNet it loaded
    from --from_pretrained; by the time the step is built, nothing holds the
    loaded one (on the card its f32 copy would add to every step's memory)."""
    from audio_diffusion_torch.training import loop

    loaded, alive = [], []
    from_pretrained, make_train_step = TorchPipeline.from_pretrained, loop.make_train_step

    def load(*args, **kw):
        pipe = from_pretrained(*args, **kw)
        loaded.append(weakref.ref(pipe.unet))
        return pipe

    def make(*args, **kw):
        alive.append(loaded[0]() is not None)
        return make_train_step(*args, **kw)

    monkeypatch.setattr(loop.AudioDiffusionPipeline, "from_pretrained", load)
    monkeypatch.setattr(loop, "make_train_step", make)
    gc.disable()
    try:
        _run(dataset_dir, seed_pipeline, str(tmp_path / "out"), 1, mixed_precision="bf16")
    finally:
        gc.enable()
    assert alive == [False]


def test_run_training_conditional_with_encodings(dataset_dir, tmp_path):
    """--encodings: a conditional UNet trains on per-file encodings (a
    pickled {audio_file: encoding}), and the saved pipeline takes encoding=."""
    import pickle

    d = str(tmp_path / "seed")
    unet = TorchUNet(TorchUNetConfig(**dict(COND_KW, sample_size=(RES, RES))))
    unet.init_params(torch.Generator().manual_seed(0))
    TorchPipeline(unet, TorchMel(x_res=RES, y_res=RES, device="cpu"), TorchDDIM(TorchSchedulerConfig(100)),
                  device="cpu").save_pretrained(d)
    rng = np.random.default_rng(1)
    enc_path = str(tmp_path / "enc.pkl")
    with open(enc_path, "wb") as fh:
        pickle.dump({f: rng.standard_normal(12).astype(np.float32)
                     for f in tdata.ImageSliceDataset(dataset_dir)._files}, fh)
    out = str(tmp_path / "out")
    run = RunConfig(dataset=dataset_dir, output_dir=out, train_batch_size=2, save_images_epochs=1000,
                    scheduler="ddim", num_train_steps=100, from_pretrained=d, encodings=enc_path, max_steps=2,
                    device="cpu")
    result = run_training(run, tt.TrainConfig(lr_warmup_steps=1, learning_rate=1e-3))
    assert result["steps"] == 2 and np.isfinite(result["losses"]).all()
    pipe = TorchPipeline.from_pretrained(out, device="cpu")
    assert pipe.unet.config.cross_attention_dim == 12
    raw = pipe(batch_size=1, steps=2, encoding=rng.standard_normal((1, 12)), return_images_only=True)
    assert raw.shape == (1, RES, RES)


def test_training_cli_on_the_cpu(dataset_dir, seed_pipeline, tmp_path):
    out = str(tmp_path / "cli")
    cmd = [sys.executable, "-m", "audio_diffusion_torch.training", "--device", "cpu", "--dataset", dataset_dir,
           "--max_steps", "2", "--from_pretrained", seed_pipeline, "--output_dir", out, "--train_batch_size", "2",
           "--lr_warmup_steps", "1", "--num_train_steps", "100", "--save_images_epochs", "1000"]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "'steps': 2" in proc.stdout and os.path.exists(os.path.join(out, "unet", "diffusion_pytorch_model.bin"))


def test_training_cli_refuses_what_the_port_does_not_run(dataset_dir):
    """--push_to_hub raises (no network path); --mesh_data 2 in one process
    raises and names the launcher (one process per card; the 2-process runs
    are in test_torch_dp_training.py)."""
    from audio_diffusion_torch.training.__main__ import main

    with pytest.raises(SystemExit):
        main(["--dataset", dataset_dir, "--device", "cpu", "--push_to_hub", "true"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        main(["--dataset", dataset_dir, "--device", "cpu", "--mesh_data", "2", "--param_sharding", "fsdp"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_training(RunConfig(dataset=dataset_dir), tt.TrainConfig())
