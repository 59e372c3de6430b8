"""The family of the teticio audio-diffusion configurations (``latent-256``, ``cond-latent-512``): a UNet over
latents or pixels, an optional KL-VAE, the ``Mel`` and DDIM, with an optional ``encoding`` per row as the UNet's
cross-attention context. The program is the port's ``AudioDiffusionPipeline``; the reference is
``reference/models.py`` and ``reference/pipeline.py``; both take the seed's weights (``core/weights.py``).

The configuration's blocks: ``unet``, ``vae`` (or null), ``mel``, ``scheduler``, ``encoding`` (``seq``, ``dim``; or
null), ``weights`` (the UNet's skeleton), ``dtype`` and ``fused_groupnorm``. The contract a family keeps is in
``core/named.py::family``.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from benchmark.core import traffic, weights
from benchmark.counts import kernels
from benchmark.counts.flops import count
from benchmark.reference import models
from benchmark.reference import pipeline as ref

TUPLE_FIELDS = ("sample_size", "block_out_channels", "down_block_types", "up_block_types")
# what the UNet and the VAE of each reference variant compute in: the reference, the control, the control's UNet
# alone, and the float32 reference with a fault planted in its UNet (every attention core returns zeros)
VARIANTS = {"float32": ("float32", "float32"), "fp8": ("fp8", "fp8"), "fp8-unet": ("fp8", "float32"),
            "attention-zero": ("float32", "float32")}


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if k in TUPLE_FIELDS and isinstance(v, list) else v for k, v in d.items()}


def unet_state(cfg: dict):
    return lambda shapes, device, seed: weights.unet_state(shapes, device, seed, cfg.get("weights"))


# ------------------------------------------------------------------ the program

def program(cfg: dict, seed: int, device):
    """The configuration's ``AudioDiffusionPipeline`` of the program, on ``device``, weights from ``seed``."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig

    sch = cfg["scheduler"]
    if sch["kind"] != "ddim":
        raise ValueError(f"scheduler {sch['kind']!r}: the benchmark drives DDIM")
    unet_cfg = UNetConfig(**_tuples(cfg["unet"]), dtype=cfg["dtype"], fused_groupnorm=cfg["fused_groupnorm"])
    unet = weights.filled(UNet2D, unet_cfg, device, unet_state(cfg), seed)
    vae = None
    if cfg.get("vae"):
        vae = weights.filled(AutoencoderKL, VAEConfig(**_tuples(cfg["vae"]), dtype=cfg["dtype"]), device,
                             weights.vae_state, seed)
    mel = Mel(**cfg["mel"], device=device)
    fields = {k: v for k, v in sch.items() if k not in ("kind", "set_alpha_to_one")}
    scheduler = DDIMScheduler(SchedulerConfig(**fields), set_alpha_to_one=sch["set_alpha_to_one"])
    return AudioDiffusionPipeline(unet, mel, scheduler, vae, device=device)


def inputs(cfg: dict, mix: dict, seed: int, i: int, device) -> dict:
    """Closed-loop request ``i``'s noise (B, h, w, c), gl_phase (B, frames, n_fft // 2 + 1) in radians and, for a
    conditional configuration, encoding (B, seq, dim)."""
    b = mix["batch"]
    u, mel = cfg["unet"], cfg["mel"]
    h, w = u["sample_size"]
    g = traffic.request_generator(device, seed, i)
    out = {"noise": torch.randn((b, h, w, u.get("in_channels", 1)), generator=g, device=device),
           "gl_phase": 2.0 * math.pi * torch.rand((b, mel["x_res"], mel["n_fft"] // 2 + 1), generator=g,
                                                  device=device)}
    if cfg.get("encoding"):
        e = cfg["encoding"]
        out["encoding"] = torch.randn((b, e["seq"], e["dim"]), generator=g, device=device)
    return out


def call(pipe, inputs: dict, mix: dict):
    """One request through the pipeline's ``__call__``; its device outputs (uint8 images, int16 audio)."""
    return pipe(noise=inputs["noise"], encoding=inputs.get("encoding"), gl_phase=inputs["gl_phase"],
                steps=mix["steps"], eta=mix["eta"], return_arrays=True, pcm16=mix["pcm16"])


def served_inputs(cfg: dict, user_seed: int) -> dict:
    """A served request's noise, from its own seed as the batcher draws it."""
    h, w = cfg["unet"]["sample_size"]
    noise = np.random.default_rng(user_seed).standard_normal((h, w, cfg["unet"].get("in_channels", 1)))
    return {"noise": torch.from_numpy(noise.astype(np.float32))}


# ---------------------------------------------------------------- the reference

def reference_unet(cfg: dict, seed: int, device, precision: str = "float32"):
    return weights.filled(lambda c: models.UNet(c, models.Arith(precision)), cfg["unet"], device, unet_state(cfg),
                          seed)


def reference_vae(cfg: dict, seed: int, device, precision: str = "float32"):
    """The VAE decoder, or None for a configuration without a VAE."""
    if not cfg.get("vae"):
        return None
    return weights.filled(lambda c: models.VAEDecoder(c, models.Arith(precision)), cfg["vae"], device,
                          weights.vae_state, seed)


def _attention_zeroed(unet):
    def forward(x, t, context):
        keep = models._attention
        models._attention = lambda arith, q, k, v: torch.zeros(q.shape[:-1] + v.shape[-1:], device=q.device)
        try:
            return unet(x, t, context)
        finally:
            models._attention = keep

    return forward


@torch.no_grad()
def reference_images(cfg: dict, seed: int, steps: int, rows: list, device, precision: str = "float32",
                     rows_per_block: int = 8) -> torch.Tensor:
    """(B, H, W) uint8 spectrograms of the rows (``noise`` and, conditional, ``encoding``), ``rows_per_block`` at a
    time: the float32 reference with TF32 off; or a variant of :data:`VARIANTS`."""
    unet_p, vae_p = VARIANTS[precision]
    noise = torch.stack([r["noise"] for r in rows]).to(device)
    ctx = torch.stack([r["encoding"] for r in rows]).to(device) if rows[0].get("encoding") is not None else None
    with ref.float32_exact():
        unet = reference_unet(cfg, seed, device, unet_p)
        vae = reference_vae(cfg, seed, device, vae_p)
        if precision == "attention-zero":
            unet = _attention_zeroed(unet)
        return ref.generate_images(unet, vae, noise, steps, cfg["scheduler"], ctx, rows_per_block)


# ------------------------------------------------------------------- the counts

def unet_forward(cfg: dict, batch: int) -> int:
    """FLOPs of one UNet forward of ``batch`` rows at one timestep (a conditional UNet with its encoding)."""
    u = cfg["unet"]
    with torch.device("meta"):
        model = models.UNet(u)
        h, w = u["sample_size"]
        x = torch.zeros((batch, h, w, u.get("in_channels", 1)))
        enc = cfg.get("encoding")
        ctx = torch.zeros((batch, enc["seq"], enc["dim"])) if enc else None
        return count(lambda: model(x, 0, ctx))


def vae_decode(cfg: dict, batch: int) -> int:
    v, u = cfg["vae"], cfg["unet"]
    with torch.device("meta"):
        model = models.VAEDecoder(v)
        h, w = u["sample_size"]
        return count(lambda: model(torch.zeros((batch, h, w, v.get("latent_channels", 1)))))


def flops(cfg: dict, mix: dict) -> dict:
    """{"denoise", "vae_decode", "total"} FLOPs of one request of the mix's ``batch`` rows and ``steps``."""
    batch, steps = mix["batch"], mix["steps"]
    out = {"denoise": steps * unet_forward(cfg, batch), "vae_decode": vae_decode(cfg, batch) if cfg.get("vae") else 0}
    out["total"] = out["denoise"] + out["vae_decode"]
    return out


def kernel_calls(kernel: str, cfg: dict, mix: dict) -> tuple:
    """(calls, least seconds) of ``kernel`` in one UNet forward of the mix's batch, and the request's forwards."""
    calls, least = kernels.per_forward(kernel, cfg, mix["batch"])
    return calls, least, mix["steps"]


def tiny(cfg: dict) -> dict:
    """The configuration with its widths and pixels cut to a CPU's size, its block types kept."""
    cfg = copy.deepcopy(cfg)
    u = cfg["unet"]
    n = len(u["block_out_channels"])
    u["block_out_channels"] = [16 * (1 + i // 2) for i in range(n)]
    u["sample_size"] = [2 ** (n - 1), 2 ** (n - 1)]
    u["norm_num_groups"] = 8
    u["layers_per_block"] = 1
    if u.get("cross_attention_dim"):
        u["cross_attention_dim"] = cfg["encoding"]["dim"] = 12
    v = cfg["vae"]
    v["block_out_channels"] = [8, 8]
    v["norm_num_groups"] = 4
    v["layers_per_block"] = 1
    v["sample_size"] = 2 * u["sample_size"][0]
    side = v["sample_size"]
    cfg["mel"].update(x_res=side, y_res=side, n_fft=128, hop_length=32, n_iter=4)
    return cfg
