"""The plain reference against the port's CPU path, at sizes a CPU test holds, on the same seeded weights."""

import math

import pytest
import torch

from benchmark.core import build, weights
from benchmark.reference import models as R
from benchmark.reference import pipeline as P
from benchmark.tests import tiny

CONFIGS = ("latent-256", "cond-latent-512")


def _port_modules(cfg):
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig

    unet = UNet2D(UNetConfig(**build._tuples(cfg["unet"]), dtype=cfg["dtype"]))
    vae = AutoencoderKL(VAEConfig(**build._tuples(cfg["vae"]), dtype=cfg["dtype"]))
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
    unet.load_state_dict(build._unet_state(cfg)(weights.shapes_of(unet), "cpu", seed))
    vae.load_state_dict(weights.vae_state(weights.shapes_of(vae), "cpu", seed))
    ru, rv = build.reference_models(cfg, seed, "cpu")
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
