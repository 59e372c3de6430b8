"""The pinned-seed rebuilds of the trained latent pipelines (port of
``scripts/rebuild_latent256.sh`` and ``scripts/rebuild_latent512.sh``), which
``scripts.rebuild_latent256`` and ``scripts.rebuild_latent512`` run:

    python -m audio_diffusion_torch.scripts.rebuild_latent256 [--output DIR] [--work DIR]
    python -m audio_diffusion_torch.scripts.rebuild_latent512 [--output DIR] [--work DIR]

Each stage runs in process, the port's own entry point with the JAX script's
flags:

1. the corpus: ``scripts.make_audio`` (24 files of 2 slices, seed 42);
2. the mel dataset (hop 512) as a folder of PNG slices,
   ``data.prepare.write_png_dataset``: the JAX script's HF dataset needs
   ``datasets`` and pandas, which this recipe does without; the folder reads
   item for item as that dataset;
3. the conditional recipe only: the seeded AudioEncoder's encoding of each
   WAV, pickled by PNG path (``data.prepare.encode_slices``);
4. the KL-VAE, ``training.train_vae.main`` (1,400 steps, the discriminator
   from step 600, seed 0);
5. the UNet over its latents, ``python -m audio_diffusion_torch.training``'s
   ``main`` (1,000 steps, bf16, 100 warm-up steps, seed 0);
6. ``bench.main`` on the saved pipeline, the recipe's two lines;
7. :func:`fidelity_record`, the scripts' closing record.

The conditional recipe keeps the JAX script's microbatch splits (the VAE at
batch 1 x accumulation 2, the UNet at 8 x 2): the effective batches are the
256 recipe's, and the recipe is a contract of both packages.

A stage whose output is complete is reused on a rerun: each is written under
``<name>.tmp`` in ``--work`` and renamed when it ends; the VAE's
``config.json`` and weights and the pipeline's ``model_index.json`` mark
theirs. The bench and the record run every time. The draws are torch's, not
threefry's, so the weights and the figures are the port's own.

The last line of the output is one JSON object: each stage's seconds, steps,
first and last logged losses and on the card its peak allocated memory, or
``reused``; both bench lines; the fidelity record and its bounds; each
stage's launches of the two kernels; the device block with the card's name
and power limit. Run at its pinned depth (every flag in ``PINNED`` at its
default), the 256 recipe holds its record to ``LATENT_256.bounds`` (the VAE's
reconstruction MAE under 30 uint8, every sample's nearest-neighbour MAE under
50) and exits non-zero after that line when a figure misses. It runs on the
card unless ``--device cpu``; without a card it raises. The flags after
``--device`` shrink a run for tests and smoke runs: corpus, resolution, step
counts, the VAE's widths, a small pipeline whose UNet the trainer starts
from, the record's batch and steps, and the bench's, down to its bf16 line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

HOP = 512
# The flags that set what the fidelity record measures: at their defaults a run is the pinned recipe
PINNED = ("files", "slices", "resolution", "vae_steps", "disc_start", "unet_steps", "unet_warmup",
          "vae_base_channels", "vae_ch_mult", "vae_norm_num_groups", "from_pretrained", "eval_batch", "eval_steps")
MODELS_DIR = Path(__file__).resolve().parents[2] / "models"  # git-ignored, beside the package


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    output: Path
    resolution: int
    vae_batch: tuple  # train_vae's batch flags
    unet_batch: tuple  # the UNet trainer's
    bench_runs: tuple  # each bench line's flags
    conditional: bool
    bounds: dict = None  # upper bounds on the pinned run's fidelity record (uint8 MAEs), each sample's NN MAE too


# The bounds: the JAX recipe recorded 21.4 and 30.7-33.9 on the same corpus (BASELINE.md); random images sit near 72
LATENT_256 = Recipe("latent256", MODELS_DIR / "latent-audio-diffusion-256", 256, ("-b", "2"),
                    ("--train_batch_size", "16"), ((), ("--dtype", "bfloat16")), False,
                    {"vae_recon_mae_uint8": 30.0, "sample_nn_mae_uint8": 50.0})
# The v5e's splits (rebuild_latent512.sh:51-56, :59-66); the f32 512 VAE decode is benched at batch 16.
CONDITIONAL_512 = Recipe("conditional_latent512", MODELS_DIR / "conditional-latent-audio-diffusion-512", 512,
                         ("-b", "1", "-g", "2"), ("--train_batch_size", "8", "--gradient_accumulation_steps", "2"),
                         (("--batch", "16"), ("--dtype", "bfloat16")), True)


def parse_args(recipe: Recipe, argv=None):
    p = argparse.ArgumentParser(prog=f"python -m audio_diffusion_torch.scripts.rebuild_{recipe.name.split('_')[-1]}",
                                description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output", type=str, default=str(recipe.output), help="the trained pipeline's directory")
    p.add_argument("--work", type=str, default=None,
                   help="corpus, dataset, encodings and VAE (default: <output>-work, beside the output)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--files", type=int, default=24)
    p.add_argument("--slices", type=int, default=2, help="slices per corpus file")
    p.add_argument("--resolution", type=int, default=recipe.resolution, help="mel image side")
    p.add_argument("--vae_steps", type=int, default=1400)
    p.add_argument("--disc_start", type=int, default=600)
    p.add_argument("--unet_steps", type=int, default=1000)
    p.add_argument("--unet_warmup", type=int, default=100, help="the UNet's learning-rate warm-up steps")
    p.add_argument("--vae_base_channels", type=int, default=128)
    p.add_argument("--vae_ch_mult", type=str, default="1,2,4,4")
    p.add_argument("--vae_norm_num_groups", type=int, default=32)
    p.add_argument("--from_pretrained", type=str, default=None,
                   help="a pixel pipeline whose UNet the trainer starts from (default: the recipe's UNet)")
    p.add_argument("--eval_batch", type=int, default=8, help="the fidelity record's slices and samples")
    p.add_argument("--eval_steps", type=int, default=50)
    p.add_argument("--bench_batch", type=int, default=None, help="default: each bench line's own")
    p.add_argument("--bench_steps", type=int, default=None)
    p.add_argument("--bench_iters", type=int, default=None)
    p.add_argument("--bench_reps", type=int, default=None)
    p.add_argument("--bench_bf16_only", action="store_true", help="the bf16 bench line alone")
    a = p.parse_args(argv)
    a.pinned = all(getattr(a, k) == p.get_default(k) for k in PINNED)
    a.output = os.path.abspath(a.output)  # the encodings are keyed by the dataset's absolute paths
    a.work = os.path.abspath(a.work or a.output + "-work")
    return a


@torch.inference_mode()
def fidelity_record(pipe, dataset_dir: str, encodings=None, seed: int = 123, batch: int = 8, steps: int = 50,
                    noise=None) -> dict:
    """The JAX scripts' closing record (rebuild_latent256.sh:48-78,
    rebuild_latent512.sh:77-113): the VAE's reconstruction MAE of the
    dataset's last ``batch`` slices (posterior mode, decoded, clipped and cast
    to uint8 as ``(x / 2 + 0.5) * 255``), and for each of ``batch`` samples
    (``return_images_only``, a generator seeded ``seed``, or ``noise``) its
    nearest-neighbour MAE over the dataset; random images sit near 72.
    ``encodings`` ({item: encoding}, a conditional pipeline): the samples are
    conditioned on its first ``batch`` distinct encodings in order, the
    first ``batch`` files, as the JAX recipe's pickle keyed by file gives
    them. ``sample_std_uint8`` is the samples' contrast, which the bench's
    trained gate bounds."""
    from ..data.dataset import ImageSliceDataset, normalize_image

    ds = ImageSliceDataset(dataset_dir)
    imgs = np.stack([ds.get(i)["image"] for i in range(len(ds))])
    held = imgs[-batch:]
    x = torch.from_numpy(normalize_image(held)[..., None]).to(pipe.device)
    rec = pipe.vqvae.decode(pipe.vqvae.encode(x).mode()).float()[..., 0].cpu().numpy()
    rec_u8 = np.clip((rec / 2 + 0.5) * 255, 0, 255).astype(np.uint8)
    vae_mae = float(np.abs(rec_u8.astype(float) - held.astype(float)).mean())

    enc = None
    if encodings is not None:
        distinct = list({np.asarray(v).tobytes(): v for v in encodings.values()}.values())
        if len(distinct) < batch:
            raise ValueError(f"{len(distinct)} distinct encodings for a batch of {batch}")
        enc = np.stack(distinct[:batch]).astype(np.float32)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    raw = pipe(batch_size=batch, steps=steps, generator=gen, noise=noise, encoding=enc, return_images_only=True)
    imgs = imgs.astype(float)
    nn_mae = [float(np.abs(imgs - r.astype(float)).mean(axis=(1, 2)).min()) for r in raw]
    return {"vae_recon_mae_uint8": vae_mae, "sample_nn_mae_uint8": nn_mae, "sample_std_uint8": float(raw.std())}


def launch_counts() -> dict:
    """The kernels' launch counters (each wrapper adds one where it launches), and the attention backwards."""
    from ..ops.attention import FlashMHA, flash_mha
    from ..ops.fused_groupnorm import group_norm_silu

    return {"group_norm_silu": group_norm_silu.launches, "flash_mha": flash_mha.launches,
            "FlashMHA.backward": FlashMHA.backwards}


def _fresh(path: str) -> str:
    """``path``.tmp, emptied: where a stage writes until it ends."""
    tmp = path + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    elif os.path.exists(tmp):
        os.remove(tmp)
    return tmp


def missed_bounds(recipe: Recipe, record: dict) -> list:
    """The figures of ``record`` not under ``recipe.bounds``, as "name value not under bound"."""
    missed = []
    for key, bound in (recipe.bounds or {}).items():
        values = record[key] if isinstance(record[key], list) else [record[key]]
        missed += [f"{key} {v:.4f} not under {bound}" for v in values if not v < bound]
    return missed


def main(recipe: Recipe, argv=None) -> dict:
    a = parse_args(recipe, argv)
    from ..bench import main as bench_main
    from ..data.dataset import load_encodings
    from ..data.prepare import encode_slices, write_png_dataset
    from ..mel import Mel
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..training.__main__ import main as unet_main
    from ..training.train_vae import main as vae_main
    from ..utils import diffusers_io
    from ..utils.measure import device_block, loss_summary, resolve_device
    from .make_audio import main as make_audio_main

    device = resolve_device(a.device)  # raises without a card unless --device cpu
    os.makedirs(a.work, exist_ok=True)
    audio_dir, ds_dir = os.path.join(a.work, "audio"), os.path.join(a.work, "ds")
    enc_path, vae_dir = os.path.join(a.work, "encodings.p"), os.path.join(a.work, "vae")
    index_path = os.path.join(ds_dir, "slices.json")  # the writer's {png: wav}, which the encodings read
    stages, launches = {}, {}

    def stage(name: str, done: bool, run) -> None:
        print(f"== [{name}] ==", flush=True)
        if done:
            stages[name] = {"reused": True}
            return
        before, t0 = launch_counts(), time.time()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        info = run() or {}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            info["peak_allocated_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        stages[name] = {"reused": False, "seconds": time.time() - t0, **info}
        launches[name] = {k: v - before[k] for k, v in launch_counts().items()}

    def corpus():
        tmp = _fresh(audio_dir)
        make_audio_main(["--output_dir", tmp, "--files", str(a.files), "--slices", str(a.slices),
                         "--resolution", str(a.resolution), "--seed", "42"])
        os.replace(tmp, audio_dir)
        return {"files": a.files}

    def dataset():
        tmp = _fresh(ds_dir)
        mel = Mel(x_res=a.resolution, y_res=a.resolution, hop_length=HOP, device=device)
        slices = write_png_dataset(mel, audio_dir, tmp)
        with open(os.path.join(tmp, "slices.json"), "w") as fh:
            json.dump({os.path.relpath(png, tmp): os.path.relpath(f, audio_dir) for png, f in slices.items()}, fh)
        os.replace(tmp, ds_dir)
        return {"slices": len(slices)}

    def encodings():
        with open(index_path) as fh:
            index = json.load(fh)
        tmp = _fresh(enc_path)
        encs = encode_slices({os.path.join(ds_dir, png): os.path.join(audio_dir, f) for png, f in index.items()},
                             tmp, device=device)
        os.replace(tmp, enc_path)
        return {"slices": len(encs)}

    def vae():
        tmp = _fresh(vae_dir)
        r = vae_main(["-d", ds_dir, *recipe.vae_batch, "--max_steps", str(a.vae_steps), "--disc_start",
                      str(a.disc_start), "--hf_checkpoint_dir", tmp, "--seed", "0", "--base_channels",
                      str(a.vae_base_channels), "--ch_mult", a.vae_ch_mult, "--norm_num_groups",
                      str(a.vae_norm_num_groups), "--device", a.device])
        os.replace(tmp, vae_dir)
        logged = r["logged_losses"]
        return {"steps": r["steps"], "train_seconds": r["seconds"], "loss_first": logged[0][1] if logged else None,
                "loss_last": logged[-1][1] if logged else None, "logged_losses": logged}

    def unet():
        conditioning = ("--encodings", enc_path) if recipe.conditional else ()
        start = ("--from_pretrained", a.from_pretrained) if a.from_pretrained else ()
        r = unet_main(["--dataset", ds_dir, "--vae", vae_dir, *conditioning, "--output_dir", a.output,
                       *recipe.unet_batch, "--scheduler", "ddim", "--mixed_precision", "bf16", "--max_steps",
                       str(a.unet_steps), "--num_epochs", "1000", "--lr_warmup_steps", str(a.unet_warmup),
                       "--save_images_epochs", "100000", "--save_model_epochs", "100000", "--seed", "0",
                       "--device", a.device, *start])
        return {"steps": r["steps"], "train_seconds": r["seconds"], **loss_summary(r["losses"])}

    def complete_vae() -> bool:
        return all(os.path.exists(os.path.join(vae_dir, f)) for f in ("config.json", diffusers_io.WEIGHTS_NAME))

    stage("corpus", os.path.isdir(audio_dir), corpus)
    stage("dataset", os.path.exists(index_path), dataset)
    if recipe.conditional:
        stage("encodings", os.path.exists(enc_path), encodings)
    stage("vae", complete_vae(), vae)
    stage("unet", os.path.exists(os.path.join(a.output, "model_index.json")), unet)

    bench_lines = []

    def bench():
        cut = [f for flag, v in (("--batch", a.bench_batch), ("--steps", a.bench_steps), ("--iters", a.bench_iters),
                                 ("--reps", a.bench_reps)) if v is not None for f in (flag, str(v))]
        for flags in recipe.bench_runs[-1:] if a.bench_bf16_only else recipe.bench_runs:
            bench_lines.append(bench_main(["--pipeline", a.output, *flags, *cut, "--device", a.device]))
            if device.type == "cuda":
                torch.cuda.empty_cache()

    record = {}

    def fidelity():
        pipe = AudioDiffusionPipeline.from_pretrained(a.output, fused_groupnorm=True, device=device)
        record.update(fidelity_record(pipe, ds_dir, load_encodings(enc_path) if recipe.conditional else None,
                                      batch=a.eval_batch, steps=a.eval_steps))
        return {"dtype": pipe.unet.config.dtype}

    stage("bench", False, bench)
    stage("fidelity", False, fidelity)
    missed = missed_bounds(recipe, record) if a.pinned else []
    result = {"recipe": recipe.name, "output": a.output, "work": a.work, "stages": stages, "bench": bench_lines,
              "fidelity": record, "bounds": {**(recipe.bounds or {}), "applied": a.pinned, "missed": missed},
              "launches": launches, "device": device_block(device)}
    print(json.dumps(result), flush=True)
    if missed:
        raise SystemExit(f"{recipe.name}: the fidelity record misses its bounds: {'; '.join(missed)}")
    return result
