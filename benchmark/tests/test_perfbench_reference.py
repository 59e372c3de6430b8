"""The plain reference against the port's CPU path, at sizes a CPU test holds, on the same seeded weights."""

import math

import pytest
import torch

from benchmark.core import named, weights
from benchmark.reference import models as R
from benchmark.reference import pipeline as P
from benchmark.tests import tiny

CONFIGS = ("latent-256", "cond-latent-512")
AD = named.load("families", "audio_diffusion")


def _port_modules(cfg):
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig

    unet = UNet2D(UNetConfig(**AD._tuples(cfg["unet"]), dtype=cfg["dtype"]))
    vae = AutoencoderKL(VAEConfig(**AD._tuples(cfg["vae"]), dtype=cfg["dtype"]))
    return unet, vae


@pytest.mark.parametrize("name", CONFIGS)
def test_same_names_and_shapes_at_full_width(name):
    """The seeded weights are drawn by name: the reference must hold exactly the program's keys."""
    cfg = tiny._load("configs", name)
    with torch.device("meta"):
        unet, vae = _port_modules(cfg)
        assert weights.shapes_of(R.UNet(cfg["unet"])) == weights.shapes_of(unet)
        dec = {k: v for k, v in weights.shapes_of(vae).items() if k.startswith(weights.DECODE_PREFIXES)}
        assert weights.shapes_of(R.VAEDecoder(cfg["vae"])) == dec


@pytest.mark.parametrize("name", CONFIGS)
def test_unet_and_vae_match_the_port(name):
    cfg = tiny.config(name)
    seed = 2**33 + 5
    unet, vae = _port_modules(cfg)
    unet.load_state_dict(AD.unet_state(cfg)(weights.shapes_of(unet), "cpu", seed))
    vae.load_state_dict(weights.vae_state(weights.shapes_of(vae), "cpu", seed))
    ru, rv = AD.reference_unet(cfg, seed, "cpu"), AD.reference_vae(cfg, seed, "cpu")
    h, w = cfg["unet"]["sample_size"]
    x = torch.randn(3, h, w, 1, generator=torch.Generator().manual_seed(1))
    enc = torch.randn(3, 1, cfg["encoding"]["dim"]) if cfg.get("encoding") else None
    with torch.no_grad():
        torch.testing.assert_close(ru(x, 741, enc), unet(x, torch.tensor(741), enc), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(rv(x), vae.decode(x), rtol=1e-4, atol=1e-4)


def test_audio_matches_the_port():
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize

    cfg = tiny.config("latent-256")
    mel = Mel(**cfg["mel"], device="cpu")
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (2, mel.y_res, mel.x_res), generator=g, dtype=torch.uint8)
    phase = 2 * math.pi * torch.rand((2, mel.x_res, mel.n_fft // 2 + 1), generator=g)
    port = pcm16_quantize(mel.images_to_audio(images, phase=phase)).float()
    ref = P.images_to_pcm16(images, phase, cfg["mel"]).float()
    assert ((port - ref).pow(2).mean() / ref.pow(2).mean()).sqrt() < 1e-3
    assert torch.equal(torch.as_tensor(P.slaney_mel_basis(22050, 2048, 256)), torch.as_tensor(
        __import__("audio_diffusion_torch.ops.mel_filters", fromlist=["x"]).mel_filterbank(22050, 2048, 256)))


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 1001)
    y = R.fp8_round(x)
    assert y.abs().max() == pytest.approx(3.0) and 0 < (y - x).abs().max()
    assert torch.all((y - x).abs() <= x.abs() / 16 + 1e-3)  # 3 bits of mantissa: half a step of 1/8
    assert torch.unique(y).numel() < 300


SCHEDULES = {"linear": (0.0001, 0.02), "scaled_linear": (0.00085, 0.012)}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("alpha_to_one", [True, False])
def test_ddim_tables_match_the_port_scheduler(schedule, offset, alpha_to_one):
    """The reference's DDIM reads the configuration's ``scheduler`` as the port's ``DDIMScheduler`` does."""
    import numpy as np

    from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig
    from audio_diffusion_torch.schedulers.common import leading_timesteps, make_betas

    b0, b1 = SCHEDULES[schedule]
    sched = {"kind": "ddim", "num_train_timesteps": 1000, "beta_start": b0, "beta_end": b1, "beta_schedule": schedule,
             "clip_sample": True, "prediction_type": "epsilon", "set_alpha_to_one": alpha_to_one,
             "steps_offset": offset}
    ddim = P.DDIM(sched)
    port = DDIMScheduler(SchedulerConfig(num_train_timesteps=1000, beta_start=b0, beta_end=b1, beta_schedule=schedule,
                                         steps_offset=offset), set_alpha_to_one=alpha_to_one)
    np.testing.assert_array_equal(ddim.alphas, np.cumprod(1.0 - make_betas(1000, b0, b1, schedule)).astype(np.float32))
    np.testing.assert_array_equal(ddim.alphas, port.alphas_cumprod)
    assert np.float32(ddim.final) == port.final_alpha_cumprod
    for steps in (3, 50, 7):
        np.testing.assert_array_equal(ddim.timesteps(steps), leading_timesteps(1000, steps, offset).timesteps)
        np.testing.assert_array_equal(ddim.timesteps(steps), port.schedule(steps).timesteps)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("clip", [True, False])
def test_ddim_steps_match_the_port_scheduler(schedule, clip):
    from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig

    b0, b1 = SCHEDULES[schedule]
    sched = {"num_train_timesteps": 1000, "beta_start": b0, "beta_end": b1, "beta_schedule": schedule,
             "clip_sample": clip, "set_alpha_to_one": False, "steps_offset": 1}
    ddim = P.DDIM(sched)
    port = DDIMScheduler(SchedulerConfig(num_train_timesteps=1000, beta_start=b0, beta_end=b1, beta_schedule=schedule,
                                         clip_sample=clip, steps_offset=1), set_alpha_to_one=False)
    schedule_ = port.schedule(10)
    g = torch.Generator().manual_seed(7)
    for t in ddim.timesteps(10):
        x, eps = torch.randn(2, 4, 4, 1, generator=g) * 1.5, torch.randn(2, 4, 4, 1, generator=g)
        torch.testing.assert_close(ddim.step(eps, int(t), x, 100), port.step(eps, int(t), x, schedule_),
                                   rtol=1e-5, atol=1e-6)


def test_ddim_refuses_what_it_does_not_compute():
    base = {"num_train_timesteps": 1000, "beta_start": 0.0001, "beta_end": 0.02, "set_alpha_to_one": True}
    with pytest.raises(ValueError, match="beta_schedule"):
        P.DDIM(dict(base, beta_schedule="squaredcos_cap_v2"))
    with pytest.raises(ValueError, match="prediction_type"):
        P.DDIM(dict(base, beta_schedule="linear", prediction_type="v_prediction"))
