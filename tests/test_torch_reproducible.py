"""The port's trainers repeat themselves bitwise, on the CPU:

- two ``train_vae.main`` runs with the same seed across ``disc_start`` save
  bitwise-equal weights and log equal losses, and the UNet trainer's ``main``
  run twice over that VAE's cached latents saves bitwise-equal pipelines;
- a training step runs in ``train_unet.repeatable`` (cuDNN's deterministic
  algorithms, which the card needs for the adversarial VAE step to repeat
  itself), and after the trainers return every flag is what it was; the window
  restores the flag after its body raises and nests across two threads;
- both deterministic settings are part of a pipeline's program keys;
- the conditional UNet's attention backward on the card (``ops.attention.SDPA``)
  recomputes under torch's deterministic algorithms and puts the setting back.
"""

import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_training import UNCOND_KW

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.models import UNet2D, UNetConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig
from audio_diffusion_torch.training import train_unet, train_vae
from audio_diffusion_torch.training.__main__ import main as unet_main
from audio_diffusion_torch.utils import diffusers_io

RES = 32  # the VAE trainer's PatchGAN needs 32x32 slices or more

# Every process-wide flag a trainer could touch, read at once
FLAGS = {
    "cudnn.enabled": lambda: torch.backends.cudnn.enabled,
    "cudnn.deterministic": lambda: torch.backends.cudnn.deterministic,
    "cudnn.benchmark": lambda: torch.backends.cudnn.benchmark,
    "cudnn.allow_tf32": lambda: torch.backends.cudnn.allow_tf32,
    "cuda.matmul.allow_tf32": lambda: torch.backends.cuda.matmul.allow_tf32,
    "deterministic_algorithms": torch.are_deterministic_algorithms_enabled,
    "deterministic_algorithms_warn_only": torch.is_deterministic_algorithms_warn_only_enabled,
}


def flags() -> dict:
    return {k: read() for k, read in FLAGS.items()}


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("slices")
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (RES, RES), dtype=np.uint8)).save(d / f"slice_{i:02d}.png")
    return str(d)


def _vae_run(dataset_dir, out, seen=None):
    """6 steps, the discriminator from step 2 (generator and discriminator
    steps alternate from there); ``seen`` collects cuDNN's deterministic flag
    at each discriminator forward."""
    handle = None
    if seen is not None:
        def record(module, args):
            seen.append(torch.backends.cudnn.deterministic)

        init = train_vae.init_vae_train_state

        def init_recorded(*args, **kw):
            state, disc = init(*args, **kw)
            nonlocal handle
            handle = disc.register_forward_pre_hook(record)
            return state, disc

        train_vae.init_vae_train_state = init_recorded
    try:
        return train_vae.main(["-d", dataset_dir, "-b", "2", "--max_steps", "6", "--disc_start", "2",
                               "--base_channels", "8", "--ch_mult", "1,2", "--norm_num_groups", "4", "--device",
                               "cpu", "--hf_checkpoint_dir", out, "--save_images_batches", "1000", "--seed", "0"])
    finally:
        if seen is not None:
            train_vae.init_vae_train_state = init
            handle.remove()


def _assert_state_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    assert not unequal, unequal


@pytest.fixture(scope="module")
def vae_runs(dataset_dir, tmp_path_factory):
    """Two VAE runs with one seed; the first records the flag inside its steps."""
    root = tmp_path_factory.mktemp("vae")
    before, seen = flags(), []
    first = _vae_run(dataset_dir, str(root / "a"), seen)
    after = flags()
    second = _vae_run(dataset_dir, str(root / "b"))
    return {"dirs": (str(root / "a"), str(root / "b")), "results": (first, second), "flags": (before, after),
            "seen": seen}


def test_vae_training_repeats_itself_across_disc_start(vae_runs):
    first, second = vae_runs["results"]
    assert first["steps"] == second["steps"] == 6
    assert first["logged_losses"] == second["logged_losses"] and first["logged_losses"]
    (_, a), (_, b) = (diffusers_io.read_vae(d) for d in vae_runs["dirs"])
    _assert_state_dicts_equal(a, b)


def test_vae_steps_run_in_the_window_and_the_flags_come_back(vae_runs):
    """Each of the 6 steps runs the discriminator (the generator step for its
    adversarial term); every forward saw the deterministic flag on."""
    before, after = vae_runs["flags"]
    assert after == before and before["cudnn.deterministic"] is False
    assert len(vae_runs["seen"]) >= 6 and set(vae_runs["seen"]) == {True}


@pytest.fixture(scope="module")
def seed_pipeline(tmp_path_factory):
    """A tiny pixel pipeline whose UNet the UNet trainer starts from (the latents are 16x16x1)."""
    d = str(tmp_path_factory.mktemp("seed"))
    unet = UNet2D(UNetConfig(**dict(UNCOND_KW, sample_size=(RES // 2, RES // 2))))
    unet.init_params(torch.Generator().manual_seed(0))
    AudioDiffusionPipeline(unet, Mel(x_res=RES, y_res=RES, device="cpu"), DDIMScheduler(SchedulerConfig(100)),
                           device="cpu").save_pretrained(d)
    return d


def _unet_run(dataset_dir, vae_dir, seed_pipeline, out):
    return unet_main(["--dataset", dataset_dir, "--vae", vae_dir, "--from_pretrained", seed_pipeline, "--output_dir",
                      out, "--train_batch_size", "2", "--max_steps", "4", "--lr_warmup_steps", "1",
                      "--num_train_steps", "100", "--scheduler", "ddim", "--save_images_epochs", "1000",
                      "--seed", "0", "--device", "cpu"])


def test_unet_training_over_cached_latents_repeats_itself(dataset_dir, vae_runs, seed_pipeline, tmp_path,
                                                          monkeypatch):
    seen = []
    make = train_unet.make_train_step

    def make_recorded(*args, **kw):
        step = make(*args, **kw)
        unet = args[1]
        unet.register_forward_pre_hook(lambda module, inputs: seen.append(torch.backends.cudnn.deterministic))
        return step

    monkeypatch.setattr("audio_diffusion_torch.training.loop.make_train_step", make_recorded)
    before = flags()
    vae_dir = vae_runs["dirs"][0]
    first = _unet_run(dataset_dir, vae_dir, seed_pipeline, str(tmp_path / "a"))
    assert flags() == before
    monkeypatch.undo()
    second = _unet_run(dataset_dir, vae_dir, seed_pipeline, str(tmp_path / "b"))
    assert first["steps"] == second["steps"] == 4
    assert first["losses"] == second["losses"]
    assert seen and set(seen) == {True}
    for part in ("unet", "vqvae"):
        _assert_state_dicts_equal(*(diffusers_io.load_state_dict(os.path.join(tmp_path / run, part))
                                    for run in ("a", "b")))


@pytest.fixture(params=[False, True], ids=["deterministic-off", "deterministic-on"])
def deterministic_before(request):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = request.param
    yield request.param
    torch.backends.cudnn.deterministic = saved


def test_the_window_restores_the_flag_when_its_body_raises(deterministic_before):
    others = flags()
    with pytest.raises(RuntimeError, match="inside"):
        with train_unet.repeatable():
            assert torch.backends.cudnn.deterministic is True
            raise RuntimeError("inside")
    assert flags() == others and torch.backends.cudnn.deterministic is deterministic_before


@pytest.mark.parametrize("closes", ["first-opened-first", "last-opened-first"])
def test_windows_nest_across_threads(deterministic_before, closes):
    """A opens, B opens, then they close in either order, each on its own
    thread: the flag is on while either is open and the prior value after."""
    opened = {n: threading.Event() for n in "AB"}
    close = {n: threading.Event() for n in "AB"}
    seen = {}

    def hold(name):
        with train_unet.repeatable():
            seen[name, "in"] = torch.backends.cudnn.deterministic
            opened[name].set()
            close[name].wait(timeout=30)
            seen[name, "last"] = torch.backends.cudnn.deterministic

    threads = {n: threading.Thread(target=hold, args=(n,)) for n in "AB"}
    for n in "AB":
        threads[n].start()
        assert opened[n].wait(timeout=30)
    first, second = "AB" if closes == "first-opened-first" else "BA"
    close[first].set()
    threads[first].join(timeout=30)
    assert not threads[first].is_alive() and torch.backends.cudnn.deterministic is True
    close[second].set()
    threads[second].join(timeout=30)
    assert not threads[second].is_alive()
    assert set(seen.values()) == {True}, seen
    assert torch.backends.cudnn.deterministic is deterministic_before


def test_the_deterministic_flags_are_part_of_the_program_keys(seed_pipeline):
    """Each window a training step opens (cuDNN's, and the attention
    backward's torch-wide one) changes the key of a captured program."""
    from audio_diffusion_torch.ops.attention import deterministic_algorithms

    pipe = AudioDiffusionPipeline.from_pretrained(seed_pipeline, device="cpu")
    fixed = pipe._fixed_key()
    with train_unet.repeatable():
        cudnn = pipe._fixed_key()
    with deterministic_algorithms():
        torch_wide = pipe._fixed_key()
    assert len({fixed, cudnn, torch_wide}) == 3 and pipe._fixed_key() == fixed


def test_the_attention_backward_runs_with_deterministic_algorithms_and_puts_them_back(monkeypatch):
    """``ops.attention.SDPA`` (the conditional UNet's attention under autograd
    on the card): its forward runs under the process's flags, the backward's
    recompute under torch's deterministic algorithms (strict), and the flags
    are back after; its gradients are the plain math's within f32 rounding."""
    from audio_diffusion_torch.ops import attention as at

    seen = []
    sdpa = at._sdpa

    def recorded(q, k, v):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled()))
        return sdpa(q, k, v)

    monkeypatch.setattr(at, "_sdpa", recorded)
    before = flags()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 4, 16, generator=g, requires_grad=True) for n in (64, 8, 8))
    out = at.SDPA.apply(q, k, v)
    grad = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), grad)
    assert seen == [(False, False), (True, False)] and flags() == before
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(at.dot_product_attention_plain(*leaves), leaves, grad)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
