"""Adversarial KL-VAE training on one device (port of ``audio_diffusion_tpu/training/train_vae.py``).

The LPIPSWithDiscriminator recipe as the JAX package builds it: an L1
reconstruction plus a perceptual term (``perceptual_kind``: avg-pool pyramid
L1, ``ssim``, ``lpips_rf`` over fixed random features, or ``none``), the NLL
scaled by a learned global ``logvar``, a KL term, and a PatchGAN
discriminator with hinge loss whose generator term is weighted adaptively by
||grad_last(nll)|| / ||grad_last(g)||, the gradients taken at the decoder's
final conv weight, clipped to 1e4 and scaled by ``disc_weight``. Generator
and discriminator steps alternate; before ``disc_start`` the discriminator
terms are weighted 0. Both optimizers are optax's Adam (train_unet.Adam).

The JAX step linearises the loss twice, once for the adaptive weight and
once for the update; here one forward serves both (``torch.autograd.grad``
at the final conv weight with the graph kept, then the full gradient): the
same values, one forward fewer. Posterior draws come injected
(``posterior_eps``, (accum, micro, h, w, C)) or from ``step_generator(seed,
step)``, one per microbatch in order.

    python -m audio_diffusion_torch.training.train_vae -d DATASET_DIR --hf_checkpoint_dir OUT [--device cpu]

saves the VAE in the diffusers layout (``config.json`` and
``diffusion_pytorch_model.bin``) every epoch, which the UNet trainer's
``--vae`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.unet2d import init_flax_defaults
from .train_unet import Adam, AdamState, repeatable, step_generator


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 4.5e-6  # CompVis base_learning_rate (ldm_autoencoder_kl.yaml:4)
    kl_weight: float = 1.0e-6
    disc_weight: float = 0.5
    disc_start: int = 50001
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    perceptual_kind: str = "pyramid"  # "pyramid" | "ssim" | "lpips_rf" | "none"
    perceptual_seed: int = 7
    disc_channels: int = 64
    disc_layers: int = 3
    adam_beta1: float = 0.5
    adam_beta2: float = 0.9


class PatchDiscriminator(nn.Module):
    """PatchGAN (pix2pix NLayerDiscriminator shape: 4x4 convs, stride-2
    pyramid, per-channel GroupNorm with flax's epsilon 1e-6, leaky ReLU 0.2).
    NHWC in, NHWC patch logits out."""

    def __init__(self, base_channels: int = 64, n_layers: int = 3, in_channels: int = 1):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = nn.Conv2d(in_channels, base_channels, 4, stride=2, padding=1)
        ch = base_channels
        for i in range(1, n_layers):
            out = min(ch * 2, 512)
            setattr(self, f"conv_{i}", nn.Conv2d(ch, out, 4, stride=2, padding=1, bias=False))
            setattr(self, f"norm_{i}", nn.GroupNorm(out, out, eps=1e-6))
            ch = out
        out = min(ch * 2, 512)
        self.conv_last = nn.Conv2d(ch, out, 4, stride=1, padding=1, bias=False)
        self.norm_last = nn.GroupNorm(out, out, eps=1e-6)
        self.conv_out = nn.Conv2d(out, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv_in(x.permute(0, 3, 1, 2)), 0.2)
        for i in range(1, self.n_layers):
            x = F.leaky_relu(getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(x)), 0.2)
        x = F.leaky_relu(self.norm_last(self.conv_last(x)), 0.2)
        return self.conv_out(x).permute(0, 2, 3, 1)


def pyramid_l1(a: torch.Tensor, b: torch.Tensor, levels: int = 3) -> torch.Tensor:
    """Multi-scale L1 of NHWC batches: the mean over an average-pool pyramid."""
    loss = torch.mean(torch.abs(a - b))
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    for _ in range(levels):
        a, b = F.avg_pool2d(a, 2, 2), F.avg_pool2d(b, 2, 2)
        loss = loss + torch.mean(torch.abs(a - b))
    return loss / (levels + 1)


@dataclasses.dataclass
class VAETrainState:
    """step counts generator and discriminator steps together; the VAE, its
    ``logvar`` and the discriminator are updated in place."""

    step: int
    vae: nn.Module
    logvar: nn.Parameter
    opt_state: AdamState
    disc: PatchDiscriminator
    disc_opt_state: AdamState

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The generator's parameters: the VAE's, then ``logvar``."""
        return {**dict(self.vae.named_parameters()), "logvar": self.logvar}


def _adam(cfg: VAETrainConfig) -> Adam:
    return Adam(cfg.learning_rate, cfg.adam_beta1, cfg.adam_beta2, 1e-8)


def init_vae_train_state(cfg: VAETrainConfig, vae, in_channels: int = 1) -> Tuple[VAETrainState, PatchDiscriminator]:
    """The train state of ``vae`` (on its device) with a fresh discriminator
    seeded 1 (flax's initialisers; torch's draws, not ``jax.random.key(1)``'s)."""
    device = next(vae.parameters()).device
    disc = PatchDiscriminator(cfg.disc_channels, cfg.disc_layers, in_channels)
    init_flax_defaults(disc, torch.Generator().manual_seed(1))
    disc = disc.to(device)
    logvar = nn.Parameter(torch.zeros((), device=device))
    state = VAETrainState(0, vae, logvar, None, disc, None)
    state.opt_state = _adam(cfg).init(state.params)
    state.disc_opt_state = _adam(cfg).init(dict(disc.named_parameters()))
    return state, disc


def make_vae_train_steps(cfg: VAETrainConfig, vae, disc: PatchDiscriminator):
    """Returns ``(gen_step, disc_step)``; each is ``state, metrics =
    step(state, images, *, seed=0, posterior_eps=None)`` with ``images``
    (B, H, W, C) or (accum, micro, H, W, C): gradients average over the
    microbatches. Alternate them per batch (train_vae.py:119-274). Each runs
    inside ``train_unet.repeatable``: on the card the generator step's
    gradient through the PatchGAN repeats itself bitwise only with cuDNN's
    deterministic algorithms."""
    if cfg.perceptual_kind not in ("pyramid", "ssim", "lpips_rf", "none"):
        raise ValueError(f"perceptual_kind={cfg.perceptual_kind!r}: expected 'pyramid' (avg-pool pyramid L1), "
                         "'ssim' (structural dissimilarity), 'lpips_rf' (LPIPS over fixed random conv features), "
                         "or 'none'")
    g_opt, d_opt = _adam(cfg), _adam(cfg)
    device = next(vae.parameters()).device
    pcpt = None
    if cfg.perceptual_weight > 0 and cfg.perceptual_kind == "lpips_rf":
        from .perceptual import init_perceptual_params

        pcpt = init_perceptual_params(torch.Generator(device=device).manual_seed(cfg.perceptual_seed),
                                      vae.config.in_channels)

    def rec_loss_of(images, rec):
        loss = cfg.pixel_weight * torch.mean(torch.abs(images - rec))
        if cfg.perceptual_weight > 0 and cfg.perceptual_kind == "lpips_rf":
            from .perceptual import perceptual_distance

            loss = loss + cfg.perceptual_weight * perceptual_distance(pcpt, images, rec)
        elif cfg.perceptual_weight > 0 and cfg.perceptual_kind == "ssim":
            from .perceptual import dssim

            loss = loss + cfg.perceptual_weight * dssim(images, rec)
        elif cfg.perceptual_weight > 0 and cfg.perceptual_kind == "pyramid":
            loss = loss + cfg.perceptual_weight * pyramid_l1(images, rec)
        return loss

    def draws(state, images, seed, posterior_eps):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        images = images[None] if images.dim() == 4 else images
        accum, micro = images.shape[:2]
        if posterior_eps is not None:
            return images, [torch.as_tensor(e, device=device) for e in posterior_eps]
        gen = step_generator(seed, state.step, device)
        shape = (micro, *vae.config.latent_hw(*images.shape[2:4]), vae.config.latent_channels)
        return images, [torch.randn(shape, generator=gen, device=device) for _ in range(accum)]

    def accumulate(acc: List[torch.Tensor], grads) -> List[torch.Tensor]:
        if not acc:
            return list(grads)
        torch._foreach_add_(acc, list(grads))
        return acc

    @repeatable()
    def gen_step(state: VAETrainState, images, *, seed: int = 0, posterior_eps=None):
        disc_factor = 1.0 if state.step >= cfg.disc_start else 0.0
        images, eps = draws(state, images, seed, posterior_eps)
        params = list(state.params.values())
        last = state.vae.decoder.conv_out.weight
        parts_sum = {"loss": 0.0, "nll": 0.0, "kl": 0.0, "g_loss": 0.0, "d_weight": 0.0}
        grad_sum: List[torch.Tensor] = []
        for img, e in zip(images, eps):
            posterior = state.vae.encode(img)
            rec = state.vae.decode(posterior.sample(eps=e))
            nll = rec_loss_of(img, rec) / torch.exp(state.logvar) + state.logvar
            kl = torch.mean(posterior.kl())
            g_loss = -torch.mean(state.disc(rec))
            nll_grad, = torch.autograd.grad(nll, last, retain_graph=True)
            g_grad, = torch.autograd.grad(g_loss, last, retain_graph=True)
            d_weight = torch.linalg.vector_norm(nll_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
            d_weight = torch.clamp(d_weight, 0.0, 1e4).detach() * cfg.disc_weight
            total = nll + cfg.kl_weight * kl + d_weight * disc_factor * g_loss
            grad_sum = accumulate(grad_sum, torch.autograd.grad(total, params))
            for k, v in (("loss", total), ("nll", nll), ("kl", kl), ("g_loss", g_loss), ("d_weight", d_weight)):
                parts_sum[k] = parts_sum[k] + v.detach()
        accum = len(eps)
        if accum > 1:
            torch._foreach_div_(grad_sum, float(accum))
        g_opt.step(params, grad_sum, state.opt_state)
        state.step += 1
        return state, {k: v / accum for k, v in parts_sum.items()}

    @repeatable()
    def disc_step(state: VAETrainState, images, *, seed: int = 0, posterior_eps=None):
        disc_factor = 1.0 if state.step >= cfg.disc_start else 0.0
        images, eps = draws(state, images, seed, posterior_eps)
        params = list(state.disc.parameters())
        loss_sum, grad_sum = 0.0, []
        for img, e in zip(images, eps):
            with torch.no_grad():
                rec = state.vae.decode(state.vae.encode(img).sample(eps=e))
            logits_real, logits_fake = state.disc(img), state.disc(rec)
            d_loss = 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))
            grad_sum = accumulate(grad_sum, torch.autograd.grad(disc_factor * d_loss, params))
            loss_sum = loss_sum + d_loss.detach()
        accum = len(eps)
        if accum > 1:
            torch._foreach_div_(grad_sum, float(accum))
        d_opt.step(params, grad_sum, state.disc_opt_state)
        state.step += 1
        return state, {"disc_loss": loss_sum / accum}

    return gen_step, disc_step


def main(argv=None):
    """scripts/train_vae.py's flags (train_vae.py:25-50) plus ``--device``."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(prog="python -m audio_diffusion_torch.training.train_vae", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--dataset_name", type=str, required=True)
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--hf_checkpoint_dir", type=str, default="models/autoencoder-kl")
    p.add_argument("-g", "--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--n_fft", type=int, default=2048)
    p.add_argument("--save_images_batches", type=int, default=1000)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--latent_channels", type=int, default=1)
    p.add_argument("--base_channels", type=int, default=128)
    p.add_argument("--ch_mult", type=str, default="1,2,4,4")
    p.add_argument("--norm_num_groups", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=4.5e-6)
    p.add_argument("--disc_start", type=int, default=50001)
    p.add_argument("--kl_weight", type=float, default=1.0e-6)
    p.add_argument("--disc_weight", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mixed_precision", type=str, default="no", choices=["no", "bf16"])
    p.add_argument("--perceptual", type=str, default="pyramid", choices=["pyramid", "ssim", "lpips_rf", "none"])
    p.add_argument("--perceptual_weight", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from ..data.dataset import ImageSliceDataset, epoch_batches, prefetch
    from ..mel import Mel
    from ..models.vae import AutoencoderKL, VAEConfig
    from ..utils import diffusers_io

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_vae: CUDA device requested but torch.cuda is not available; pass --device cpu")
    dataset = ImageSliceDataset(a.dataset_name)
    resolution = dataset.resolution
    vae_cfg = VAEConfig(block_out_channels=tuple(a.base_channels * int(m) for m in a.ch_mult.split(",")),
                        latent_channels=a.latent_channels, sample_size=resolution[0],
                        norm_num_groups=a.norm_num_groups,
                        dtype="bfloat16" if a.mixed_precision == "bf16" else "float32")
    vae = AutoencoderKL(vae_cfg).init_params(torch.Generator().manual_seed(a.seed)).to(device)

    # CompVis scales the base LR by accum * batch (train_vae.py:78-79)
    cfg = VAETrainConfig(learning_rate=a.learning_rate * a.gradient_accumulation_steps * a.batch_size,
                         disc_start=a.disc_start, kl_weight=a.kl_weight, disc_weight=a.disc_weight,
                         perceptual_kind=a.perceptual, perceptual_weight=a.perceptual_weight)
    state, disc = init_vae_train_state(cfg, vae)
    gen_step, disc_step = make_vae_train_steps(cfg, vae, disc)

    writer = None
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(a.hf_checkpoint_dir, "logs"))
    except ImportError:
        pass
    mel = Mel(x_res=resolution[1], y_res=resolution[0], hop_length=a.hop_length, sample_rate=a.sample_rate,
              n_fft=a.n_fft, device=device)

    rng = np.random.default_rng(a.seed)
    step = 0
    gen_metrics = {}
    logged = []  # (step, loss) of every logged step
    t0 = time.time()
    for epoch in range(a.max_epochs):
        for batch in prefetch(epoch_batches(dataset, a.batch_size, a.gradient_accumulation_steps, rng),
                              transform=lambda b: torch.from_numpy(b[0]).to(device)):
            # before disc_start every step is a generator step: a discriminator
            # step would be a zero-gradient no-op (train_vae.py:108-121)
            if step < a.disc_start or step % 2 == 0:
                state, gen_metrics = gen_step(state, batch, seed=a.seed)
                metrics = dict(gen_metrics)
            else:
                state, disc_metrics = disc_step(state, batch, seed=a.seed)
                metrics = {**gen_metrics, **disc_metrics}
            step += 1
            if step % 50 == 0 or step == 1:
                logs = {k: float(v) for k, v in metrics.items()}
                logged.append((step, logs["loss"]))
                logging.info("epoch %d step %d: %s", epoch, step, logs)
                if writer:
                    for k, v in logs.items():
                        writer.add_scalar(f"vae/{k}", v, step)
            if writer and step % a.save_images_batches == 0:
                with torch.no_grad():
                    rec = state.vae.decode(state.vae.encode(batch[0][:4]).mode())
                grid = np.clip(rec.float().cpu().numpy()[..., 0] / 2 + 0.5, 0, 1)
                writer.add_images("vae/reconstructions", (grid * 255).astype(np.uint8)[:, None], step)
                from ..ops.audio_io import normalize

                audio = mel.images_to_audio(torch.from_numpy((grid[:1] * 255).astype(np.uint8)).to(device))
                try:
                    writer.add_audio("vae/reconstruction_audio", normalize(audio[0].cpu().numpy())[None, :], step,
                                     sample_rate=a.sample_rate)
                except ImportError:  # tensorboardX add_audio needs soundfile
                    pass
            if a.max_steps and step >= a.max_steps:
                break
        # save every epoch (reference: HFModelCheckpoint on_train_epoch_end), diffusers layout
        diffusers_io.write_json(diffusers_io.vae_config_to_diffusers(vae_cfg),
                                os.path.join(a.hf_checkpoint_dir, "config.json"))
        diffusers_io.save_state_dict(state.vae, a.hf_checkpoint_dir)
        if a.max_steps and step >= a.max_steps:
            break
    if writer:
        writer.close()
    result = {"steps": step, "seconds": time.time() - t0, "output": a.hf_checkpoint_dir, "logged_losses": logged}
    print(result)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
