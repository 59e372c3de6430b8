"""Run one training step twice from one state and say which gradients differ.

    python -m audio_diffusion_torch.scripts.repeat_probe [--flags default|cudnn|torch] [--out FILE]

The adversarial VAE step of the 256 rebuild recipe (full width: 128-channel
VAE with ch_mult 1,2,4,4, the 64-channel PatchGAN, batch 2), one bf16 step
of the full-width latent-256 UNet over cached latents (microbatch 16), and
one of the conditional-latent-512 UNet (64x64 latents, an encoding per row,
8 x 2 microbatches, as the 512 recipe trains it). The VAE trains on the cut
corpus of the rebuild smoke run (8 files of 3 slices, seed 42) through
``train_vae``'s alternation until its step is past ``disc_start`` (24), so
both the generator's and the discriminator's adversarial terms are on. Then
each step runs twice, each time on a deep copy of that state with the same
batch and the same draws, and every gradient the step takes is compared
bitwise: the generator step's ``nll_grad`` and ``g_grad`` at the decoder's
last conv weight, its ``d_weight`` and the gradient of its total loss, the
discriminator step's gradient, each UNet step's gradient, and the
parameters after the update. Each PatchGAN convolution's data and weight
gradients at the shapes of that batch, and the conditional UNet's attention
core at each of its shapes through each SDPA backend and the plain math,
are taken twice outside the trainers and compared too. Last, 40 more steps
of each trainer (10 of the conditional UNet) give its steps/s.

``--flags`` sets what the process runs under: ``default`` (the trainers as
they are), ``cudnn`` (``torch.backends.cudnn.deterministic`` for the whole
run), ``torch`` (``torch.use_deterministic_algorithms(True,
warn_only=True)``: the warnings name every op with no deterministic
implementation) and ``strict`` (the same with ``warn_only=False``, which
also switches ops that have both to their deterministic form). For the last
two, start the process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in its
environment, which torch and cuBLAS read once. One JSON object is the last
line."""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import tempfile
import time
import warnings

import numpy as np
import torch

from ..training import train_vae
from ..training.train_unet import Adam

VAE_DISC_START = 24
TIMED_STEPS = 40  # steps of each trainer timed after its pair
COND_TIMED_STEPS = 10  # the conditional UNet's


@contextlib.contextmanager
def recording(names: dict):
    """Record, as clones, what ``torch.autograd.grad`` returns for inputs that
    are all in ``names`` ({id(tensor): name}) and every gradient list handed
    to ``Adam.step``: [(label, [(name, tensor)])] in call order."""
    calls = []
    grad, step = torch.autograd.grad, Adam.step

    def named(tensors):
        return [names.get(id(t)) for t in tensors]

    def grad_recorded(outputs, inputs, *args, **kw):
        out = grad(outputs, inputs, *args, **kw)
        inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
        if all(named(inputs)):
            calls.append(("autograd.grad", list(zip(named(inputs), [g.detach().clone() for g in out]))))
        return out

    def step_recorded(self, params, grads, *args, **kw):
        calls.append(("Adam.step", list(zip(named(params), [g.detach().clone() for g in grads]))))
        return step(self, params, grads, *args, **kw)

    torch.autograd.grad, Adam.step = grad_recorded, step_recorded
    try:
        yield calls
    finally:
        torch.autograd.grad, Adam.step = grad, step


def differences(a: dict, b: dict) -> dict:
    """{name: [max |a - b|, differing elements, elements]} of the tensors that are not bitwise equal."""
    out = {}
    for k, x in a.items():
        y = b[k]
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs()
            out[k] = [float(d.max()), int((x != y).sum()), x.numel()]
    return out


def compare_runs(first, second) -> dict:
    """The two runs' recorded gradients, metrics and final parameters; each
    run is (calls, metrics, {name: parameter after the step})."""
    (calls_a, metrics_a, params_a), (calls_b, metrics_b, params_b) = first, second
    if [c[0] for c in calls_a] != [c[0] for c in calls_b]:
        raise RuntimeError("the two runs took different gradients")
    grads = []
    for (label, a), (_, b) in zip(calls_a, calls_b):
        what = a[0][0] if len(a) == 1 else f"{len(a)} tensors"
        grads.append({"call": label, "of": what, "differ": differences(dict(a), dict(b))})
    metrics = {k: [float(metrics_a[k]), float(metrics_b[k])] for k in metrics_a}
    return {"bitwise": all(not g["differ"] for g in grads) and all(x == y for x, y in metrics.values())
            and not differences(params_a, params_b),
            "grads": grads, "metrics": metrics, "params_differ": differences(params_a, params_b)}


def run_twice(step, state, params_of, *args, **kw) -> dict:
    """``step(copy, *args, **kw)`` on two deep copies of ``state``;
    ``params_of(state)`` names the tensors to record and compare."""
    runs = []
    for _ in range(2):
        s = copy.deepcopy(state)
        names = {id(t): k for k, t in params_of(s).items()}
        with recording(names) as calls:
            s, metrics = step(s, *args, **kw)
        runs.append((calls, metrics, {k: t.detach().clone() for k, t in params_of(s).items()}))
    return compare_runs(*runs)


def vae_params(state) -> dict:
    return {**state.params, **{f"disc.{k}": p for k, p in state.disc.named_parameters()}}


def vae_setup(device, resolution: int = 256, base_channels: int = 128, ch_mult=(1, 2, 4, 4), groups: int = 32,
              batch: int = 2, disc_start: int = VAE_DISC_START, seed: int = 0):
    """What ``train_vae.main`` builds for ``-b batch --disc_start disc_start
    --seed seed``: (state, gen_step, disc_step)."""
    from ..models.vae import AutoencoderKL, VAEConfig

    cfg = VAEConfig(block_out_channels=tuple(base_channels * m for m in ch_mult), latent_channels=1,
                    sample_size=resolution, norm_num_groups=groups)
    vae = AutoencoderKL(cfg).init_params(torch.Generator().manual_seed(seed)).to(device)
    tcfg = train_vae.VAETrainConfig(learning_rate=4.5e-6 * batch, disc_start=disc_start)
    state, disc = train_vae.init_vae_train_state(tcfg, vae)
    return state, *train_vae.make_vae_train_steps(tcfg, vae, disc)


def vae_pair(state, gen_step, disc_step, batch, seed: int = 0) -> dict:
    """The generator and the discriminator step each run twice from ``state``
    on ``batch`` ((1, B, H, W, 1)) with one posterior draw."""
    vae = state.vae
    shape = (1, batch.shape[1], *vae.config.latent_hw(*batch.shape[2:4]), vae.config.latent_channels)
    device = next(vae.parameters()).device
    eps = torch.randn(shape, generator=torch.Generator(device=device).manual_seed(seed + 1), device=device)
    return {"gen_step": run_twice(gen_step, state, vae_params, batch, posterior_eps=eps),
            "disc_step": run_twice(disc_step, state, vae_params, batch, posterior_eps=eps)}


def conv_pairs(disc, x, seed: int = 0) -> dict:
    """Each convolution of the PatchGAN at the shape a forward of ``x`` gives
    it, outside any trainer: its data and weight gradients for one seeded
    output gradient, taken twice and compared bitwise (None: equal)."""
    convs = {name: m for name, m in disc.named_modules() if isinstance(m, torch.nn.Conv2d)}
    inputs = {}
    hooks = [m.register_forward_hook(lambda m, args, y, name=name: inputs.__setitem__(name, args[0].detach()))
             for name, m in convs.items()]
    try:
        with torch.no_grad():
            disc(x)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device=x.device).manual_seed(seed)
    out = {}
    for name, conv in convs.items():
        xi = inputs[name].clone().requires_grad_(True)
        y = conv(xi)
        g = torch.randn(y.shape, generator=gen, device=y.device)
        first, second = ({"data": d, "weight": w} for d, w in
                         (torch.autograd.grad(y, (xi, conv.weight), g, retain_graph=True) for _ in range(2)))
        diff = differences(first, second)
        out[name] = {"input": list(xi.shape), "output": list(y.shape), "data_grad_differ": diff.get("data"),
                     "weight_grad_differ": diff.get("weight")}
    return out


def unet_pair(device, sample_hw=(32, 32), micro: int = 16, accum: int = 1, dtype: str = "bfloat16",
              cross_attention_dim=None, seed: int = 0, timed_steps: int = 0, **config) -> dict:
    """One step of a UNet over cached latents, run twice from one initial
    state: two deep copies of the UNet, each with its own train state and
    step (no warm-up, so the first update moves the parameters). The
    latent-256 UNet (``unconditional_config``) by default; with
    ``cross_attention_dim`` the conditional one (``conditional_config``), a
    seeded encoding per row. ``config``: other ``UNetConfig`` fields. Then
    ``timed_steps`` more steps of the second copy, timed (``steps_per_sec``)."""
    from ..models.unet2d import UNet2D, conditional_config, unconditional_config
    from ..schedulers import DDIMScheduler, SchedulerConfig
    from ..training.train_unet import TrainConfig, init_train_state, make_train_step

    conditional = cross_attention_dim is not None
    unet_cfg = (conditional_config(sample_hw, 1, 1, cross_attention_dim=cross_attention_dim, dtype=dtype, **config)
                if conditional else unconditional_config(sample_hw, 1, 1, dtype=dtype, **config))
    unet = UNet2D(unet_cfg).init_params(torch.Generator().manual_seed(seed)).to(device).train()
    cfg = TrainConfig(lr_warmup_steps=0, gradient_accumulation_steps=accum)
    scheduler = DDIMScheduler(SchedulerConfig(num_train_timesteps=1000))
    rng = np.random.default_rng(seed)
    moments = np.concatenate([rng.standard_normal((accum, micro, *sample_hw, 1)),
                              rng.uniform(-6, -2, (accum, micro, *sample_hw, 1))], axis=-1).astype(np.float32)
    encodings = rng.standard_normal((accum, micro, 1, cross_attention_dim)).astype(np.float32) if conditional else None
    runs = []
    for model in (unet, copy.deepcopy(unet)):
        state = init_train_state(cfg, model)
        step = make_train_step(cfg, model, scheduler, conditional=conditional, cached_latents=True)
        with recording({id(p): k for k, p in state.params.items()}) as calls:
            state, metrics = step(state, moments, encodings, seed=seed)
        runs.append((calls, {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]},
                     {k: p.detach().clone() for k, p in state.params.items()}))
    result = compare_runs(*runs)
    if timed_steps:
        result["steps_per_sec"] = steps_per_sec(lambda: step(state, moments, encodings, seed=seed), timed_steps,
                                                device)
    if conditional:
        result["attention"] = attention_pairs(model, moments[0], encodings[0], scheduler)
    return result


def attention_pairs(unet, moments, encodings, scheduler, reps: int = 5) -> dict:
    """Each distinct (query, key) shape the conditional UNet's attention core
    (``ops.attention.dot_product_attention``) sees in a training forward, and
    for each a seeded (q, k, v, output gradient) run forward and backward
    twice through SDPA as torch dispatches it, through each of its backends
    alone, through the plain math (``dot_product_attention_plain``) under
    autograd, and through the port's training path (``ops.attention.SDPA``):
    bitwise or not, and ms per forward+backward (CUDA events, the
    mean of ``reps`` after one warm-up)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ..models import unet2d
    from ..ops.attention import SDPA, dot_product_attention_plain

    device = next(unet.parameters()).device
    shapes = {}
    core = unet2d.dot_product_attention

    def seen(q, k, v):
        shapes.setdefault((tuple(q.shape), tuple(k.shape)), q.dtype)
        return core(q, k, v)

    unet2d.dot_product_attention = seen
    try:
        with torch.no_grad():
            x = torch.from_numpy(moments[..., :1]).to(device)
            t = torch.full((x.shape[0],), 500, dtype=torch.int64, device=device)
            unet(x, t, torch.from_numpy(encodings).to(device))
    finally:
        unet2d.dot_product_attention = core

    def sdpa(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    variants = {"sdpa": (sdpa, None), "flash": (sdpa, SDPBackend.FLASH_ATTENTION),
                "efficient": (sdpa, SDPBackend.EFFICIENT_ATTENTION), "cudnn": (sdpa, SDPBackend.CUDNN_ATTENTION),
                "math": (sdpa, SDPBackend.MATH), "plain": (dot_product_attention_plain, None),
                "port": (SDPA.apply, None)}
    out = {}
    for (q_shape, k_shape), dtype in shapes.items():
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn(sh, generator=gen, device=device).to(dtype) for sh in (q_shape, k_shape, k_shape))
        g = torch.randn(q_shape, generator=gen, device=device).to(dtype)
        row = {}
        for name, (fn, backend) in variants.items():
            def fwd_bwd():
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
                    o = fn(*leaves)
                    return torch.autograd.grad(o, leaves, g)

            try:
                first, second = fwd_bwd(), fwd_bwd()
            except RuntimeError as e:
                row[name] = {"error": str(e).split("\n")[0][:160]}
                continue
            diff = differences(dict(zip("qkv", first)), dict(zip("qkv", second)))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fwd_bwd()
            end.record()
            end.synchronize()
            row[name] = {"bitwise": not diff, "differ": diff, "ms": start.elapsed_time(end) / reps}
        out[f"q{list(q_shape)} k{list(k_shape)}"] = row
    return out


def steps_per_sec(run_step, n: int, device) -> float:
    """``n`` calls of ``run_step`` over the host's wall clock, the device drained before and after."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        run_step()
    sync()
    return n / (time.perf_counter() - t0)


def corpus_batches(device, root: str, files: int = 8, slices: int = 3, resolution: int = 256):
    """The rebuild smoke run's cut corpus as a dataset, and ``epoch_batches``
    of it as ``train_vae.main`` draws them (seed 0, batch 2) on the device."""
    from ..data.dataset import ImageSliceDataset, epoch_batches
    from ..data.prepare import write_png_dataset
    from ..mel import Mel
    from .make_audio import main as make_audio_main
    from .rebuild import HOP

    audio, ds = os.path.join(root, "audio"), os.path.join(root, "ds")
    make_audio_main(["--output_dir", audio, "--files", str(files), "--slices", str(slices), "--resolution",
                     str(resolution), "--seed", "42"])
    write_png_dataset(Mel(x_res=resolution, y_res=resolution, hop_length=HOP, device=device), audio, ds)
    dataset, rng = ImageSliceDataset(ds), np.random.default_rng(0)
    while True:
        for images, _ in epoch_batches(dataset, 2, 1, rng):
            yield torch.from_numpy(images).to(device)


def vae_steps(state, gen_step, disc_step, batches, n: int, disc_start: int = VAE_DISC_START):
    """``n`` more steps of ``train_vae.main``'s alternation: generator steps
    before ``disc_start``, then generator and discriminator in turn."""
    for _ in range(n):
        batch = next(batches)
        if state.step < disc_start or state.step % 2 == 0:
            state, _ = gen_step(state, batch)
        else:
            state, _ = disc_step(state, batch)
    return state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m audio_diffusion_torch.scripts.repeat_probe", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--flags", choices=("default", "cudnn", "torch", "strict"), default="default")
    p.add_argument("--out", type=str, default=None, help="also write the JSON object here")
    a = p.parse_args(argv)
    from ..utils.measure import device_block, resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("repeat_probe: torch.cuda.is_available() is False; the probe runs on an NVIDIA GPU")
    device = resolve_device("cuda")
    if a.flags in ("torch", "strict"):
        if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
            raise SystemExit(f"--flags {a.flags}: start the process with CUBLAS_WORKSPACE_CONFIG=:4096:8")
        torch.use_deterministic_algorithms(True, warn_only=a.flags == "torch")
    elif a.flags == "cudnn":
        torch.backends.cudnn.deterministic = True
    with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as root:
        warnings.simplefilter("always")
        batches = corpus_batches(device, root)
        state, gen_step, disc_step = vae_setup(device)
        state = vae_steps(state, gen_step, disc_step, batches, VAE_DISC_START + 1)
        batch = next(batches)
        result = {"flags": a.flags, "vae": vae_pair(state, gen_step, disc_step, batch),
                  "disc_convs": conv_pairs(state.disc, batch[0])}
        result["vae"]["steps_per_sec"] = steps_per_sec(
            lambda: vae_steps(state, gen_step, disc_step, batches, 1), TIMED_STEPS, device)
        del state, gen_step, disc_step
        result["unet"] = unet_pair(device, timed_steps=TIMED_STEPS)
        result["cond_unet"] = unet_pair(device, (64, 64), micro=8, accum=2, cross_attention_dim=100,
                                        timed_steps=COND_TIMED_STEPS)
    result["nondeterministic_ops"] = sorted({str(w.message).split("\n")[0] for w in caught
                                             if "deterministic" in str(w.message)})
    result["device"] = device_block(device)
    line = json.dumps(result)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
