"""UNet diffusion training, on one device or data parallel (port of ``audio_diffusion_tpu/training/train_unet.py``).

One optimization step is: per microbatch of the (accum, micro, H, W, C)
batch, the DDPM loss (MSE against epsilon or the velocity) and its
gradients, accumulated; the mean gradient clipped by global norm; AdamW with
a warmup-cosine (linear, constant) learning rate; the EMA update. The
arithmetic is optax's, in its order, so the same gradients give the same
parameters within f32 rounding: ``clip_by_global_norm`` scales by
``max / norm`` only where ``norm >= max``; AdamW adds ``wd * p`` to the
bias-corrected Adam update and scales by ``-lr(count)`` with the count taken
before its increment (the first update under warmup uses lr 0).

Hyperparameter defaults mirror the JAX package's (its docstring lists their
sources in the reference trainer).

Data parallelism. The JAX step is one SPMD program over a mesh; here one
process runs per card and :func:`wrap_unet` (the counterpart of
``shard_train_state``) wraps the UNet over the default process group:
``param_sharding="replicated"`` in ``DistributedDataParallel``, ``"fsdp"`` in
FSDP2's ``fully_shard`` on each resnet, attention and resampler and on the
root, every parameter split on the axis :func:`..parallel.fsdp_sharding_for`
picks. FSDP2 cannot keep a parameter whole inside a group, so the ones the
JAX rule leaves replicated (small, or no divisible axis) split on dim 0: the
values are the same, only where they live differs. A wrapped step takes this
rank's rows of the microbatch axis (``batch_shardings``' counterpart is
:func:`..parallel.batch_slice`); gradients are averaged over ranks by the
wrapper (DDP's all-reduce, FSDP's reduce-scatter) once per optimizer step,
the microbatches before the last running without that sync; the optimizer
and the EMA update each rank's own shards; the loss is all-reduced to the
global mean, bitwise the same on every rank. Without a process group
:func:`wrap_unet` returns the UNet and both settings are the one-device step.
No mixed-precision policy is given to FSDP: the UNet casts to bf16 inside, as
the JAX step does, and gradients reduce in f32.

Random draws. torch cannot reproduce ``jax.random``, so a step takes its
draws injected (``timesteps``, ``noise``, ``posterior_eps``, each with the
(accum, micro, ...) leading axes; how tests hand both packages one draw) or
draws them from :func:`step_generator` ``(seed, step)``, the counterpart of
``fold_in(key(seed), step)``: a resumed run draws what the straight run drew.
Per microbatch, in order: the timesteps (micro,), then on the latent paths
the posterior's standard normal eps, then the noise, both of the latents'
shape. Draws are always of the whole microbatch: a data-parallel rank draws
every row, in the same order as one device, and keeps its own, so the DP step
is the one-device step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.fsdp import FSDPModule
from torch.nn.parallel import DistributedDataParallel

from ..models.ema import EMA
from ..models.vae import DiagonalGaussian
from ..parallel.mesh import batch_slice, fsdp_sharding_for, is_sharded, local, world
from ..pipelines.pipeline import LATENT_SCALE
from ..utils.flag_window import attribute_window

# Every training step of the port (this module's, and train_vae's generator and discriminator steps) runs with
# cuDNN restricted to its deterministic algorithms, so that a run repeats itself bitwise on the card as the JAX
# trainers do on theirs. Left free, cuDNN's heuristics pick a data-gradient convolution for the PatchGAN's first
# layer that sums in a run-dependent order (scripts/repeat_probe.py), and the choice is made per shape. The flag is
# one for the whole process: it is set only while a step runs and put back after (``with repeatable():``). The
# conditional UNet's attention backward has its own window (ops/attention.py::SDPA).
repeatable = attribute_window(torch.backends.cudnn, "deterministic", True)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    lr_schedule: str = "cosine"  # cosine | linear | constant (reference --lr_scheduler)
    lr_warmup_steps: int = 500
    total_steps: int = 100_000
    adam_beta1: float = 0.95
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-6
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    use_ema: bool = True
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    ema_max_decay: float = 0.9999
    param_sharding: str = "replicated"  # "replicated" (DDP) or "fsdp" (FSDP2), over the default process group
    prediction_type: str = "epsilon"  # "epsilon" (reference default) | "v_prediction"


# ------------------------------------------------------------ learning rate

def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """``optax.linear_schedule`` in its f32 arithmetic; constant ``init`` when steps <= 0."""
    if steps <= 0:
        return np.float32(init)
    frac = np.float32(1.0) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return np.float32(init - end) * frac + np.float32(end)


def _cosine(init: float, decay_steps: int, count: int) -> np.float32:
    """``optax.cosine_decay_schedule`` with alpha 0 and exponent 1, f32."""
    c = np.float32(min(count, decay_steps))
    cos = np.cos(np.float32(np.pi) * c / np.float32(decay_steps))
    return np.float32(init) * (np.float32(0.5) * (np.float32(1.0) + cos))


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate, optax's values (train_unet.py:65-83). The
    decay steps include the warmup; the lr at count 0 is 0 under warmup."""
    lr, warm = cfg.learning_rate, cfg.lr_warmup_steps
    decay_steps = max(cfg.total_steps, warm + 1)
    if cfg.lr_schedule == "cosine":
        def after(c):
            return _cosine(lr, decay_steps - warm, c)
    elif cfg.lr_schedule == "linear":
        def after(c):
            return _linear(lr, 0.0, decay_steps - warm, c)
    elif cfg.lr_schedule == "constant":
        def after(c):
            return np.float32(lr)
    else:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")

    def schedule(count: int) -> float:
        count = int(count)
        return float(_linear(0.0, lr, warm, count) if count < warm else after(count - warm))

    return schedule


# ---------------------------------------------------------------- optimizer

@dataclasses.dataclass
class AdamState:
    """optax's Adam state: the update count and the two moments, keyed like the parameters."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tensors: Sequence[torch.Tensor], sharded: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``), a
    0-dim tensor. ``sharded``: the tensors are this rank's FSDP shards, and the
    squares are summed over the ranks (an all-reduce every rank enters)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if not sharded:
        return torch.linalg.vector_norm(norms)
    sq = norms.square().sum()
    dist.all_reduce(sq)
    return sq.sqrt()


class Adam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(...))``, or
    ``optax.adam`` with ``weight_decay=None`` and ``max_grad_norm=None``,
    updating parameters in place with one multi-tensor launch per operation.
    ``learning_rate`` is a float or a count -> float schedule."""

    def __init__(self, learning_rate, b1: float, b2: float, eps: float, weight_decay: Optional[float] = None,
                 max_grad_norm: Optional[float] = None):
        self.lr = learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        """Zero moments placed like the parameters (an FSDP parameter's are sharded alike)."""
        def zeros(p):
            return torch.zeros_like(p) if is_sharded(p) else torch.zeros_like(p, memory_format=torch.contiguous_format)

        return AdamState(0, {k: zeros(p) for k, p in params.items()}, {k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
             grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update of ``params`` from ``grads`` (modified in place), in
        ``state``'s key order. ``grad_norm``, when given, is ``global_norm(grads)``.
        With FSDP every list holds this rank's shards: the update is elementwise."""
        if self.max_grad_norm is not None:
            norm = float(global_norm(grads) if grad_norm is None else grad_norm)
            if not norm < self.max_grad_norm:  # optax: select(norm < max, g, (g / norm) * max)
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.max_grad_norm)
        mu, nu = [local(t) for t in state.mu.values()], [local(t) for t in state.nu.values()]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        count = state.count + 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(count))
        bc2 = float(one - np.float32(b2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        if self.weight_decay is not None:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, float(-np.float32(self.lr(state.count))))
        torch._foreach_add_(params, upd)
        state.count = count


def make_optimizer(cfg: TrainConfig) -> Adam:
    return Adam(make_lr_schedule(cfg), cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                weight_decay=cfg.adam_weight_decay, max_grad_norm=cfg.max_grad_norm)


# -------------------------------------------------------------- train state

@dataclasses.dataclass
class TrainState:
    """step counts optimizer steps; params are the UNet's own parameters
    (updated in place; DTensors under FSDP); ema_params a params-keyed copy
    placed alike, or None without EMA."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamState
    ema_params: Optional[Dict[str, torch.Tensor]]


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The UNet inside what :func:`wrap_unet` made (FSDP2 keeps the module itself)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def _fsdp_units(unet) -> list:
    """The modules the UNet calls (its blocks are containers with no forward of their own)."""
    return [m for blk in (*unet.down_blocks, unet.mid_block, *unet.up_blocks)
            for name in ("resnets", "attentions", "downsamplers", "upsamplers") for m in getattr(blk, name, ())]


def wrap_unet(cfg: TrainConfig, unet: torch.nn.Module) -> torch.nn.Module:
    """The UNet made data parallel over the default process group (the
    counterpart of ``shard_train_state``): ``DistributedDataParallel`` for
    ``"replicated"``, FSDP2 for ``"fsdp"`` (module docstring). Call it on the
    UNet in place on its device, before :func:`init_train_state`, which must
    see the wrapped parameters. Without a process group the UNet comes back
    as it is."""
    if cfg.param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_sharding {cfg.param_sharding!r}")
    if not (dist.is_available() and dist.is_initialized()):
        return unet
    device = next(unet.parameters()).device
    if cfg.param_sharding == "replicated":
        return DistributedDataParallel(unet, device_ids=[device] if device.type == "cuda" else None)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    world_size = dist.get_world_size()
    mesh = init_device_mesh(device.type, (world_size,))

    def placement(p):
        axis = fsdp_sharding_for(p.shape, world_size)
        return Shard(0 if axis is None else axis)

    for m in _fsdp_units(unet):
        fully_shard(m, mesh=mesh, shard_placement_fn=placement)
    return fully_shard(unet, mesh=mesh, shard_placement_fn=placement)


def init_train_state(cfg: TrainConfig, unet: torch.nn.Module) -> TrainState:
    """The state of ``unet`` or of what :func:`wrap_unet` made of it."""
    params = dict(unwrap(unet).named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()} if cfg.use_ema else None
    return TrainState(0, params, make_optimizer(cfg).init(params), ema)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of optimization step ``step`` of a run seeded ``seed``:
    the counterpart of ``jax.random.fold_in(jax.random.key(seed), step)``."""
    mixed = int(np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@torch.inference_mode()
def precompute_latent_moments(vae, dataset, chunk: int = 16):
    """Encode the whole dataset once on the VAE's device; returns ((N, h, w, 2C)
    numpy moments as mean ‖ logvar, audio_files). Chunks are padded to one
    shape with copies of their last item (train_unet.py:138-177)."""
    from ..data.dataset import normalize_image

    device = next(vae.parameters()).device
    moments, files, buf = [], [], []

    def flush():
        arr = np.stack(buf + [buf[-1]] * (chunk - len(buf)))[..., None]
        post = vae.encode(torch.from_numpy(arr).to(device))
        moments.append(torch.cat([post.mean, post.logvar], dim=-1)[: len(buf)].float().cpu().numpy())
        buf.clear()

    for i in range(len(dataset)):
        item = dataset.get(i)
        files.append(item["audio_file"])
        buf.append(normalize_image(item["image"]))
        if len(buf) == chunk:
            flush()
    if buf:
        flush()
    return np.concatenate(moments), files


# ------------------------------------------------------------------- step

def make_loss_fn(cfg: TrainConfig, unet, scheduler, vae=None, conditional: bool = False,
                 cached_latents: bool = False) -> Callable:
    """``loss_fn(images, encodings, timesteps, noise, posterior_eps=None)`` of
    one microbatch: the scalar MSE of train_unet.py:208-228. ``images`` are
    pixels, or with ``cached_latents`` posterior moments (mean ‖ logvar);
    latents are ``LATENT_SCALE`` times a posterior sample, without gradient."""

    def loss_fn(images, encodings, timesteps, noise, posterior_eps=None):
        clean = images
        if cached_latents:
            mean, logvar = torch.chunk(images, 2, dim=-1)
            clean = LATENT_SCALE * DiagonalGaussian(mean, logvar).sample(eps=posterior_eps)
        elif vae is not None:
            with torch.no_grad():
                clean = LATENT_SCALE * vae.encode(images).sample(eps=posterior_eps)
        clean = clean.detach()
        noisy = scheduler.add_noise(clean, noise, timesteps)
        pred = unet(noisy, timesteps, encodings if conditional else None)
        target = scheduler.velocity(clean, noise, timesteps) if cfg.prediction_type == "v_prediction" else noise
        return torch.mean((pred - target) ** 2)

    return loss_fn


def make_train_step(cfg: TrainConfig, unet, scheduler, vae=None, conditional: bool = False,
                    cached_latents: bool = False, record_events: bool = False) -> Callable:
    """Build the train step.

    ``state, metrics = step(state, images, encodings=None, *, seed=0,
    timesteps=None, noise=None, posterior_eps=None)`` with ``images`` of
    shape (accum, micro, H, W, C) and ``encodings`` (accum, micro, seq, dim)
    or None, numpy or tensors; ``state`` is updated in place and returned.
    ``metrics``: ``loss`` (mean over microbatches) and ``grad_norm`` (of the
    mean gradient, before clipping) as 0-dim device tensors, ``ema_decay``
    (at the new step) as a float. Draws: the module docstring. With
    ``record_events`` on a CUDA device each call appends CUDA events (start,
    after the backward passes, after the optimizer and EMA) to ``step.events``.
    A step runs inside :data:`repeatable`.

    ``unet`` may be what :func:`wrap_unet` made: then ``images`` and
    ``encodings`` are this rank's rows of the microbatch axis, the injected
    draws are the whole microbatch's (every rank is handed the same), and
    ``loss`` is the global mean.
    """
    optimizer = make_optimizer(cfg)
    ema = EMA(cfg.ema_inv_gamma, cfg.ema_power, cfg.ema_max_decay)
    loss_fn = make_loss_fn(cfg, unet, scheduler, vae, conditional, cached_latents)
    num_train_timesteps = scheduler.config.num_train_timesteps
    device = next(unwrap(unet).parameters()).device
    latent = cached_latents or vae is not None
    ddp = isinstance(unet, DistributedDataParallel)
    fsdp = isinstance(unet, FSDPModule)
    rank, world_size = world() if (ddp or fsdp) else (0, 1)

    def gradient_sync(last: bool):
        """Average over ranks on the last microbatch only (accumulate locally before it)."""
        if fsdp:
            unet.set_requires_gradient_sync(last)
        return unet.no_sync() if ddp and not last else contextlib.nullcontext()

    def latent_shape(images):
        if cached_latents:
            return (*images.shape[2:-1], images.shape[-1] // 2)
        if vae is not None:
            return (*vae.config.latent_hw(*images.shape[2:4]), vae.config.latent_channels)
        return tuple(images.shape[2:])

    @repeatable()
    def train_step(state: TrainState, images, encodings=None, *, seed: int = 0, timesteps=None, noise=None,
                   posterior_eps=None):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        if encodings is not None:
            encodings = torch.as_tensor(encodings, dtype=torch.float32, device=device)
        accum, micro = images.shape[:2]
        rows = batch_slice(micro * world_size, rank, world_size)  # this rank's rows of the global microbatch
        injected = [x is not None for x in (timesteps, noise, *((posterior_eps,) if latent else ()))]
        if any(injected) and not all(injected):
            raise ValueError("inject every draw the step needs (timesteps, noise"
                             + (", posterior_eps" if latent else "") + ") or none")
        gen = None if all(injected) else step_generator(seed, state.step, device)
        shape = (micro * world_size, *latent_shape(images))
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if (
            record_events and device.type == "cuda") else None
        if events:
            events[0].record()

        params = list(state.params.values())
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=device)
        for i in range(accum):
            if gen is None:
                t, eps, n = (torch.as_tensor(x[i], device=device)[rows] if x is not None else None
                             for x in (timesteps, posterior_eps, noise))
            else:
                t = torch.randint(0, num_train_timesteps, shape[:1], generator=gen, device=device)[rows]
                eps = torch.randn(shape, generator=gen, device=device)[rows] if latent else None
                n = torch.randn(shape, generator=gen, device=device)[rows]
            with gradient_sync(i == accum - 1):
                loss = loss_fn(images[i], None if encodings is None else encodings[i], t, n.float(), eps)
                loss.backward()
            loss_sum = loss_sum + loss.detach()
        if events:
            events[1].record()
        grads = [p.grad for p in params]
        missing = [k for k, g in zip(state.params, grads) if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:4]} ({len(missing)} parameters)")
        params, grads = [local(p) for p in params], [local(g) for g in grads]
        if accum > 1:  # the wrappers average over ranks; the microbatches are summed
            torch._foreach_div_(grads, float(accum))
        grad_norm = global_norm(grads, sharded=fsdp)
        optimizer.step(params, grads, state.opt_state, grad_norm)
        state.step += 1
        ema_decay = 0.0
        if cfg.use_ema:
            ema_decay = ema.update([local(e) for e in state.ema_params.values()], params, state.step)
        loss = loss_sum / accum
        if ddp or fsdp:
            dist.all_reduce(loss)
            loss = loss / world_size
        if events:
            events[2].record()
            recorded.append(events)
        return state, {"loss": loss, "ema_decay": ema_decay, "grad_norm": grad_norm}

    # The events list is reached through its own cell, not through train_step: a function that names itself in
    # its body is its own reference cycle, and with it the model and its gradients would wait for the collector.
    recorded = []
    train_step.events = recorded
    return train_step
