"""A toy text-to-spectrogram family: what a configuration of a new kind of model brings as new files only
(``benchmark/tests/test_perfbench_additive.py`` adds it to a copy of the harness and runs its cell).

The port's UNet (conditional, in pixel space, no VAE) under classifier-free guidance, conditioned by a plain-torch
causal text tower over token ids drawn from the seed. The tower runs once per request, on the empty prompt's ids
(all 0) and the request's; every DDIM step runs the UNet on 2B rows, the unconditioned and the conditioned, and
steps with eps = uncond + ``guidance_scale`` * (cond - uncond). The reference follows the same recipe with the
benchmark's reference UNet (``reference/models.py``) and DDIM (``reference/pipeline.py``); both sides make the
seed's weights themselves.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.core import traffic, weights
from benchmark.counts import kernels
from benchmark.counts.flops import count
from benchmark.reference import models
from benchmark.reference import pipeline as ref

TOWER_TAG = 11
TUPLE_FIELDS = ("sample_size", "block_out_channels", "down_block_types", "up_block_types")


class TowerLayer(nn.Module):
    """Pre-LayerNorm causal self-attention and a GELU MLP, each with a residual."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.qkv, self.out = nn.Linear(width, 3 * width), nn.Linear(width, width)
        self.fc1, self.fc2 = nn.Linear(width, 4 * width), nn.Linear(4 * width, width)

    def forward(self, x):
        b, n, w = x.shape
        q, k, v = (t.reshape(b, n, self.heads, w // self.heads).transpose(1, 2)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        s = q @ k.transpose(-1, -2) / math.sqrt(w // self.heads)
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
        x = x + self.out((torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, n, w))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class TextTower(nn.Module):
    """Token and position embeddings, ``layers`` causal layers, a final LayerNorm: (B, seq) ids -> (B, seq, width)."""

    def __init__(self, c: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(c["vocab"], c["width"])
        self.position_embedding = nn.Embedding(c["seq"], c["width"])
        self.layers = nn.ModuleList([TowerLayer(c["width"], c["heads"]) for _ in range(c["layers"])])
        self.final_norm = nn.LayerNorm(c["width"])

    def forward(self, ids):
        x = self.token_embedding(ids) + self.position_embedding.weight[:ids.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


def _tower(cfg: dict, device, seed: int) -> TextTower:
    return weights.filled(TextTower, cfg["tower"], device,
                          lambda shapes, dev, s: weights.draw(shapes.items(), dev, s, TOWER_TAG), seed)


def _guided(eps: torch.Tensor, scale: float) -> torch.Tensor:
    uncond, cond = eps.chunk(2)
    return uncond + scale * (cond - uncond)


class ToyGuidedPipeline:
    def __init__(self, unet, tower, mel, scheduler, scale: float, device):
        self.unet, self.tower, self.mel, self.scheduler = unet, tower, mel, scheduler
        self.scale, self.device = scale, torch.device(device)

    @torch.no_grad()
    def __call__(self, noise, tokens, gl_phase, steps: int, eta: float):
        from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize, postprocess_images

        context = self.tower(torch.cat([torch.zeros_like(tokens), tokens]))
        schedule = self.scheduler.schedule(steps)
        x = noise
        for t in schedule.timesteps:
            eps = self.unet(torch.cat([x, x]), torch.tensor(int(t), device=self.device), context)
            x = self.scheduler.step(_guided(eps, self.scale), int(t), x, schedule, eta=eta)
        images = postprocess_images(x)
        return images, pcm16_quantize(self.mel.images_to_audio(images, phase=gl_phase))


def program(cfg: dict, seed: int, device):
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.schedulers import DDIMScheduler, SchedulerConfig

    u = {k: tuple(v) if k in TUPLE_FIELDS else v for k, v in cfg["unet"].items()}
    unet = weights.filled(UNet2D, UNetConfig(**u, dtype=cfg["dtype"]), device, weights.unet_state, seed)
    sch = cfg["scheduler"]
    fields = {k: v for k, v in sch.items() if k not in ("kind", "set_alpha_to_one")}
    scheduler = DDIMScheduler(SchedulerConfig(**fields), set_alpha_to_one=sch["set_alpha_to_one"])
    return ToyGuidedPipeline(unet, _tower(cfg, device, seed), Mel(**cfg["mel"], device=device), scheduler,
                             cfg["guidance_scale"], device)


def inputs(cfg: dict, mix: dict, seed: int, i: int, device) -> dict:
    b, (h, w), mel, tower = mix["batch"], cfg["unet"]["sample_size"], cfg["mel"], cfg["tower"]
    g = traffic.request_generator(device, seed, i)
    return {"noise": torch.randn((b, h, w, 1), generator=g, device=device),
            "gl_phase": 2.0 * math.pi * torch.rand((b, mel["x_res"], mel["n_fft"] // 2 + 1), generator=g,
                                                   device=device),
            "tokens": torch.randint(1, tower["vocab"], (b, tower["seq"]), generator=g, device=device)}


def call(pipe, inputs: dict, mix: dict):
    return pipe(inputs["noise"], inputs["tokens"], inputs["gl_phase"], mix["steps"], mix["eta"])


@torch.no_grad()
def reference_images(cfg: dict, seed: int, steps: int, rows: list, device, precision: str = "float32",
                     rows_per_block: int = 8) -> torch.Tensor:
    arith = models.Arith({"float32": "float32", "fp8": "fp8", "fp8-unet": "fp8"}[precision])
    noise = torch.stack([r["noise"] for r in rows]).to(device)
    tokens = torch.stack([r["tokens"] for r in rows]).to(device)
    scale = cfg["guidance_scale"]
    with ref.float32_exact():
        unet = weights.filled(lambda c: models.UNet(c, arith), cfg["unet"], device, weights.unet_state, seed)
        tower = _tower(cfg, device, seed)
        uncond = tower(torch.zeros_like(tokens[:1]))

        def guided(x, t, cond):
            return _guided(unet(torch.cat([x, x]), t, torch.cat([uncond.expand_as(cond), cond])), scale)

        return ref.generate_images(guided, None, noise, steps, cfg["scheduler"], tower(tokens), rows_per_block)


def flops(cfg: dict, mix: dict) -> dict:
    rows, (h, w), tower = 2 * mix["batch"], cfg["unet"]["sample_size"], cfg["tower"]
    with torch.device("meta"):
        unet, text = models.UNet(cfg["unet"]), TextTower(tower)
        ids = torch.zeros((rows, tower["seq"]), dtype=torch.long)
        x, ctx = torch.zeros((rows, h, w, 1)), torch.zeros((rows, tower["seq"], tower["width"]))
        out = {"text": count(lambda: text(ids)), "denoise": mix["steps"] * count(lambda: unet(x, 0, ctx))}
    out["total"] = out["text"] + out["denoise"]
    return out


def kernel_calls(kernel: str, cfg: dict, mix: dict) -> tuple:
    calls, least = kernels.per_forward(kernel, cfg, 2 * mix["batch"])
    return calls, least, mix["steps"]


def tiny(cfg: dict) -> dict:
    return copy.deepcopy(cfg)
