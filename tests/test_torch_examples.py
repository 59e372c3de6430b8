"""The port's examples and scripts run end to end (as tests/test_examples.py
runs the JAX package's): each ``python -m audio_diffusion_torch.examples.<name>``
and the conditional-selectivity recipe runs in a subprocess of its own on
the CPU (``--device cpu``), at toy scale, against tiny saved pipelines in
either layout; ``scripts.make_audio`` writes the JAX script's WAV bytes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import synth_audio

from audio_diffusion_torch.mel import Mel
from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
from audio_diffusion_torch.ops.audio_io import write_wav
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler, DDPMScheduler, SchedulerConfig
from audio_diffusion_torch.utils import diffusers_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(block_out_channels=(8, 16), down_block_types=("DownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=4)
TINY_COND = dict(TINY, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4, cross_attention_dim=100)


def run_module(module, args, cwd, timeout=600):
    # One intra-op thread: the examples' tiny ops gain nothing from more, and beside other test processes on every
    # core a pool of threads per op mostly waits.
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", f"audio_diffusion_torch.{module}", *args, "--device", "cpu"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (f"{module} failed\n--- stdout ---\n{proc.stdout[-3000:]}"
                                  f"\n--- stderr ---\n{proc.stderr[-3000:]}")
    return proc


def _tiny_pipe(unet_kw, sample, mel_res, scheduler):
    unet = UNet2D(UNetConfig(sample_size=(sample, sample), **unet_kw)).init_params(torch.Generator().manual_seed(0))
    return AudioDiffusionPipeline(unet, Mel(x_res=mel_res, y_res=mel_res, hop_length=512, n_iter=4, device="cpu"),
                                  scheduler, device="cpu")


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Two short synthetic clips on disk (what every notebook starts from)."""
    d = tmp_path_factory.mktemp("audio")
    for i in range(2):
        write_wav(str(d / f"clip{i}.wav"), synth_audio(3 * 16 * 512, seed=i), 22050)
    return str(d)


@pytest.fixture(scope="module")
def tiny_pipe_dirs(tmp_path_factory):
    """A tiny DDPM pipeline standing in for a published model id, saved in
    both layouts (DDPM so that test_model also takes its DDIM swap). 50
    training timesteps: DDPM's default of one step per timestep, and the
    fewest under which test_model's 50-step DDIM section still has a
    timestep per step."""
    pipe = _tiny_pipe(TINY, 16, 16, DDPMScheduler(SchedulerConfig(num_train_timesteps=50)))
    dirs = {}
    for layout in diffusers_io.LAYOUTS:
        dirs[layout] = str(tmp_path_factory.mktemp(layout))
        pipe.save_pretrained(dirs[layout], layout=layout)
    return dirs


def test_example_mel(tmp_path):
    run_module("examples.test_mel", [], str(tmp_path))
    assert (tmp_path / "slice0.png").exists() and (tmp_path / "slice0_roundtrip.wav").exists()


def test_example_model(tmp_path, tiny_pipe_dirs, audio_dir):
    """The whole inference matrix against the tiny pipeline in the JAX
    package's native layout."""
    proc = run_module("examples.test_model", [tiny_pipe_dirs["native"], os.path.join(audio_dir, "clip0.wav")],
                      str(tmp_path))
    for f in ("generated.wav", "variation.wav", "outpainted.wav", "remixed.wav", "inpainted.wav", "eta1.wav",
              "slerp_mix.wav"):
        assert (tmp_path / f).exists(), f
    assert "encode->reconstruct image MAE" in proc.stdout


def test_example_train_model(tmp_path, audio_dir, tiny_pipe_dirs):
    out = tmp_path / "out"
    run_module("examples.train_model", [audio_dir, str(out), "--epochs", "1", "--resolution", "16", "--hop", "512",
                                        "--steps", "2", "--from_pretrained", tiny_pipe_dirs["diffusers"]],
               str(tmp_path))
    assert (out / "sample.png").exists() and (out / "model" / "model_index.json").exists()


@pytest.fixture(scope="module")
def dataset64_dir(tmp_path_factory, audio_dir):
    """A 64x64 mel dataset (the smallest the default UNet's 6 blocks accept as
    32x32 latents under a 1-downsample VAE)."""
    from audio_diffusion_torch.data.prepare import audio_to_images

    d = tmp_path_factory.mktemp("ds64")
    audio_to_images(audio_dir, str(d), resolution=(64, 64), hop_length=1024, device="cpu")
    return str(d)


def test_example_latent_diffusion(tmp_path, dataset64_dir):
    out = tmp_path / "latent"
    run_module("examples.latent_diffusion", [dataset64_dir, str(out), "--quick"], str(tmp_path))
    assert (out / "latent_sample.png").exists() and (out / "latent_sample.wav").exists()


def test_example_vae(tmp_path, dataset64_dir):
    """A VAE directory in the native layout (config.json + params.msgpack)."""
    vae = AutoencoderKL(VAEConfig(block_out_channels=(8, 16), layers_per_block=1, latent_channels=1, sample_size=64,
                                  norm_num_groups=4)).init_params(torch.Generator().manual_seed(0))
    diffusers_io.write_vae(vae, str(tmp_path / "vae"), "native")
    run_module("examples.test_vae", [str(tmp_path / "vae"), dataset64_dir], str(tmp_path))
    for f in ("vae_rec.png", "vae_sample.png", "vae_slerp.png"):
        assert (tmp_path / f).exists(), f


def test_example_conditional(tmp_path, audio_dir):
    pipe = _tiny_pipe(TINY_COND, 16, 16, DDIMScheduler(SchedulerConfig(num_train_timesteps=100)))
    pipe.save_pretrained(str(tmp_path / "cond_pipe"))
    run_module("examples.conditional_generation", [str(tmp_path / "cond_pipe"), os.path.join(audio_dir, "clip1.wav")],
               str(tmp_path))
    assert (tmp_path / "conditional.wav").exists()


def test_cond_selectivity_evidence_smoke(tmp_path):
    """The recipe end to end at its smallest: 32x32 mels (the VAE trainer's
    PatchGAN needs at least that), a small VAE and a small conditional UNet to
    start from, 2 steps each; the last line reports every class."""
    import json

    pipe = _tiny_pipe(TINY_COND, 16, 32, DDIMScheduler(SchedulerConfig()))
    pipe.save_pretrained(str(tmp_path / "start"), layout="native")
    proc = run_module("scripts.cond_selectivity_evidence",
                      ["--work", str(tmp_path / "work"), "--files_per_class", "4", "--vae_steps", "2",
                       "--unet_steps", "2", "--resolution", "32", "--vae_base_channels", "8", "--vae_ch_mult", "1,2",
                       "--vae_norm_num_groups", "4", "--from_pretrained", str(tmp_path / "start"),
                       "--eval_batch", "2", "--eval_steps", "2"], str(tmp_path))
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result["per_class"]) == {"low_arp", "high_arp", "perc_noise", "tone_chord"}
    assert result["unet"]["steps"] == 2 and result["vae"]["steps"] == 2 and result["files"] == 16
    assert result["unet"]["loss_window"] == 2
    assert np.isfinite([result["unet"]["loss_first_mean"], result["unet"]["loss_last_mean"]]).all()
    assert os.path.exists(result["grid"])


def test_make_audio_writes_the_jax_scripts_bytes(tmp_path):
    from audio_diffusion_torch.scripts import make_audio
    from scripts import make_audio as jax_make_audio

    for mod, out in ((make_audio, tmp_path / "port"), (jax_make_audio, tmp_path / "jax")):
        mod.main(["--output_dir", str(out), "--files", "2", "--slices", "1", "--resolution", "32", "--seed", "7"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    assert np.frombuffer((tmp_path / "port" / names[0]).read_bytes()[44:], np.int16).std() > 0
