"""The system under test and the reference, built from a configuration file and a seed.

The program's modules are made on the ``meta`` device, given storage on the
run's device, and filled with the benchmark's seeded weights
(:mod:`.weights`); nothing is initialised on the host and copied. The
reference models regenerate the same weights from the same seed.
"""

from __future__ import annotations

import torch

from . import weights

TUPLE_FIELDS = ("sample_size", "block_out_channels", "down_block_types", "up_block_types")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if k in TUPLE_FIELDS and isinstance(v, list) else v for k, v in d.items()}


def _filled(cls, config, device, state_fn, seed):
    with torch.device("meta"):
        module = cls(config)
    module = module.to_empty(device=device)
    state = state_fn(weights.shapes_of(module), device, seed)
    module.load_state_dict(state, strict=True)
    return module.eval()


def _unet_state(cfg: dict):
    return lambda shapes, device, seed: weights.unet_state(shapes, device, seed, cfg.get("weights"))


def program_pipeline(cfg: dict, seed: int, device):
    """The configuration's ``AudioDiffusionPipeline`` of the program, on ``device``, weights from ``seed``."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig

    sch = cfg["scheduler"]
    if sch["kind"] != "ddim":
        raise ValueError(f"scheduler {sch['kind']!r}: the benchmark drives DDIM")
    unet_cfg = UNetConfig(**_tuples(cfg["unet"]), dtype=cfg["dtype"], fused_groupnorm=cfg["fused_groupnorm"])
    unet = _filled(UNet2D, unet_cfg, device, _unet_state(cfg), seed)
    vae = None
    if cfg.get("vae"):
        vae = _filled(AutoencoderKL, VAEConfig(**_tuples(cfg["vae"]), dtype=cfg["dtype"]), device, weights.vae_state,
                      seed)
    mel = Mel(**cfg["mel"], device=device)
    fields = {k: v for k, v in sch.items() if k not in ("kind", "set_alpha_to_one")}
    scheduler = DDIMScheduler(SchedulerConfig(**fields), set_alpha_to_one=sch["set_alpha_to_one"])
    return AudioDiffusionPipeline(unet, mel, scheduler, vae, device=device)


def reference_models(cfg: dict, seed: int, device, precision: str = "float32"):
    """(UNet, VAE decoder or None) of the plain reference with the seed's weights, in ``precision``."""
    from ..reference.models import Arith, UNet, VAEDecoder

    arith = Arith(precision)
    unet = _filled(lambda c: UNet(c, arith), cfg["unet"], device, _unet_state(cfg), seed)
    vae = None
    if cfg.get("vae"):
        vae = _filled(lambda c: VAEDecoder(c, arith), cfg["vae"], device, weights.vae_state, seed)
    return unet, vae
