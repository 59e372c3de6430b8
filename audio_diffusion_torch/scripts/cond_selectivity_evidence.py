"""Conditional-latent selectivity evidence at 256x256 (port of
``scripts/cond_selectivity_evidence.py``).

Builds a 4-class synthetic corpus with well-separated spectra, assigns ONE
fixed encoding per class (the port's random-init AudioEncoder embedding of a
class exemplar: the reference's pretrained Deej-AI encoder is unfetchable,
reference: README.md:209-218), trains the reference's conditional-latent
recipe (a KL-VAE to 32x32 latents, ``training.train_vae``, then the
cross-attention UNet over them, ``python -m audio_diffusion_torch.training``
with ``--encodings``), then measures whether generation conditioned on class
k lands nearer class k's spectrograms than the other classes' (own-class
against best other-class nearest-neighbour MAE) and writes a sample grid.

One command, pinned seeds, on the card unless ``--device cpu``:

    python -m audio_diffusion_torch.scripts.cond_selectivity_evidence --work DIR

The last line of its output is one JSON object: the selectivity per class,
the grid's path, and each trainer's steps, seconds and losses.

The class synthesis below is the JAX script's, byte for byte: the corpus is
a pinned-seed contract of that file, and it does not share code with
``make_audio`` so that it cannot drift with it. The encoder's random init
draws from torch, not from ``jax.random``, so the encodings, and with them
the selectivity numbers, are the port's own. The dataset is written as a
folder of PNG slices (the ``datasets`` package is not needed), each named
after its WAV. A VAE already under ``--work/vae``, in either layout (the JAX
package's ``params.msgpack`` too), is reused, as the JAX script reuses it.
The flags after ``--seed`` shrink the run for a smoke test (the resolution,
the VAE's widths, a small conditional pipeline to start the UNet from, and
the evaluation's batch and steps).
"""

import argparse
import json
import os
import pickle
import wave

import numpy as np

SR = 22050
HOP = 512
CLASSES = ["low_arp", "high_arp", "perc_noise", "tone_chord"]
LOSS_WINDOW = 10


def synth_class(cls: str, rng: np.random.Generator, n: int) -> np.ndarray:
    t = np.arange(n) / SR
    audio = np.zeros(n, np.float64)
    if cls in ("low_arp", "high_arp"):
        lo = 110.0 if cls == "low_arp" else 1760.0
        freqs = lo * 2 ** (np.array([0, 3, 5, 7, 10]) / 12.0)
        note = int(0.18 * SR)
        for k in range(n // note):
            f = freqs[rng.integers(len(freqs))]
            s, e = k * note, min(n, k * note + int(0.5 * SR))
            tt = np.arange(e - s) / SR
            env = np.exp(-tt * rng.uniform(3, 8))
            for h, a in ((1, 1.0), (2, 0.5), (3, 0.25)):
                audio[s:e] += a * env * np.sin(2 * np.pi * f * h * tt + rng.uniform(0, 6.28))
    elif cls == "perc_noise":
        hit = int(0.06 * SR)
        for s in range(0, n - hit, int(0.22 * SR)):
            burst = rng.normal(0, 1, hit) * np.exp(-np.arange(hit) / (0.012 * SR))
            audio[s:s + hit] += burst
    else:  # tone_chord: sustained pure chords, slow changes
        seg = int(1.2 * SR)
        for s in range(0, n, seg):
            e = min(n, s + seg)
            tt = np.arange(e - s) / SR
            root = 440.0 * 2 ** (rng.integers(-3, 4) / 12.0)
            for ratio in (1.0, 1.26, 1.5):
                audio[s:e] += 0.5 * np.sin(2 * np.pi * root * ratio * tt + rng.uniform(0, 6.28))
    audio /= np.abs(audio).max() + 1e-9
    return audio.astype(np.float64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m audio_diffusion_torch.scripts.cond_selectivity_evidence",
                                description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work", type=str, required=True, help="directory for the corpus, models, grid")
    p.add_argument("--files_per_class", type=int, default=6)
    p.add_argument("--vae_steps", type=int, default=1200)
    # Conditioning gradients come almost entirely from high-noise timesteps
    # (class identity is readable from x_t elsewhere; tests/test_conditioning.py),
    # so selectivity needs more steps than loss convergence suggests.
    p.add_argument("--unet_steps", type=int, default=6000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int, default=256, help="mel image side (hop 512)")
    p.add_argument("--vae_base_channels", type=int, default=128)
    p.add_argument("--vae_ch_mult", type=str, default="1,2,4,4")
    p.add_argument("--vae_norm_num_groups", type=int, default=32)
    p.add_argument("--from_pretrained", type=str, default=None,
                   help="a conditional pipeline whose UNet the trainer starts from (default: the recipe's UNet)")
    p.add_argument("--eval_batch", type=int, default=8)
    p.add_argument("--eval_steps", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def write_corpus(a, audio_dir: str) -> dict:
    """[1/6]: files_per_class WAVs per class, one slice each, from one pinned-seed stream."""
    slice_len = a.resolution * HOP - 1
    rng = np.random.default_rng(a.seed)
    files_by_class = {c: [] for c in CLASSES}
    for c in CLASSES:
        for i in range(a.files_per_class):
            path = os.path.join(audio_dir, f"{c}_{i:02d}.wav")
            pcm = (synth_class(c, rng, slice_len + 1024) * 32000).astype(np.int16)
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes(pcm.tobytes())
            files_by_class[c].append(path)
    return files_by_class


def write_dataset(files_by_class: dict, ds_dir: str, mel) -> dict:
    """[2/6]: every slice of every WAV as ``<wav stem>_<slice>.png``; returns
    {png path: class}."""
    from ..data.prepare import file_to_examples

    os.makedirs(ds_dir, exist_ok=True)
    png_class = {}
    for c, files in files_by_class.items():
        for f in files:
            stem = os.path.splitext(os.path.basename(f))[0]
            for ex in file_to_examples(mel, f):
                path = os.path.join(ds_dir, f"{stem}_{ex['slice']}.png")
                with open(path, "wb") as fh:
                    fh.write(ex["image"]["bytes"])
                png_class[path] = c
    return png_class


def main(argv=None) -> dict:
    a = parse_args(argv)
    import torch

    from ..mel import Mel
    from ..models.audio_encoder import AudioEncoder
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..training.__main__ import main as unet_main
    from ..training.train_vae import main as vae_main

    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cond_selectivity_evidence: CUDA device requested but torch.cuda is not available; "
                         "pass --device cpu")
    audio_dir = os.path.join(a.work, "audio")
    os.makedirs(audio_dir, exist_ok=True)

    print("== [1/6] 4-class corpus ==", flush=True)
    files_by_class = write_corpus(a, audio_dir)

    print(f"== [2/6] {a.resolution}x{a.resolution} dataset ==", flush=True)
    ds_dir = os.path.join(a.work, "ds")
    mel = Mel(x_res=a.resolution, y_res=a.resolution, hop_length=HOP, sample_rate=SR, device=device)
    png_class = write_dataset(files_by_class, ds_dir, mel)

    print("== [3/6] per-class encodings (random-init AudioEncoder on one exemplar) ==", flush=True)
    encoder = AudioEncoder().init_params(torch.Generator().manual_seed(a.seed)).to(device).eval()
    class_enc = {c: encoder.encode([files_by_class[c][0]]).cpu().numpy()[0] for c in CLASSES}
    enc_path = os.path.join(a.work, "encodings.p")
    with open(enc_path, "wb") as fh:
        pickle.dump({png: class_enc[c] for png, c in png_class.items()}, fh)

    print("== [4/6] KL-VAE on the class corpus ==", flush=True)
    vae_dir = os.path.join(a.work, "vae")
    vae_result = None
    if not os.path.exists(os.path.join(vae_dir, "config.json")):
        vae_result = vae_main(["-d", ds_dir, "-b", "2", "--max_steps", str(a.vae_steps),
                               "--disc_start", str(a.vae_steps * 2), "--hf_checkpoint_dir", vae_dir,
                               "--seed", str(a.seed), "--base_channels", str(a.vae_base_channels),
                               "--ch_mult", a.vae_ch_mult, "--norm_num_groups", str(a.vae_norm_num_groups),
                               "--device", a.device])

    print("== [5/6] conditional-latent UNet ==", flush=True)
    model_dir = os.path.join(a.work, "model")
    unet_result = unet_main(["--dataset", ds_dir, "--vae", vae_dir, "--encodings", enc_path,
                             "--output_dir", model_dir, "--train_batch_size", "16",
                             "--scheduler", "ddim", "--mixed_precision", "bf16",
                             "--max_steps", str(a.unet_steps), "--num_epochs", "100000",
                             "--lr_warmup_steps", "200", "--save_images_epochs", "1000000",
                             "--save_model_epochs", "1000000", "--seed", str(a.seed), "--device", a.device]
                            + (["--from_pretrained", a.from_pretrained] if a.from_pretrained else []))

    print("== [6/6] selectivity eval ==", flush=True)
    from PIL import Image

    from ..data.dataset import ImageSliceDataset

    # bf16 as trained; the GroupNorm+SiLU kernel on the card (it has no backward, so training ran without it)
    pipe = AudioDiffusionPipeline.from_pretrained(model_dir, dtype="bfloat16", fused_groupnorm=True, device=device)
    ds = ImageSliceDataset(ds_dir)
    by_class_imgs = {c: [] for c in CLASSES}
    for i in range(len(ds)):
        item = ds.get(i)
        by_class_imgs[png_class[item["audio_file"]]].append(item["image"])
    for c in CLASSES:
        by_class_imgs[c] = np.stack(by_class_imgs[c]).astype(np.float32)

    report, grid_rows = {}, []
    for c in CLASSES:
        enc = np.broadcast_to(class_enc[c], (a.eval_batch, class_enc[c].shape[-1])).astype(np.float32)[:, None, :]
        generator = torch.Generator(device=device).manual_seed(1234)
        raw = pipe(batch_size=a.eval_batch, steps=a.eval_steps, generator=generator, encoding=enc,
                   return_images_only=True).astype(np.float32)
        grid_rows.append(np.concatenate(list(raw[:4].astype(np.uint8)), axis=1))
        nn = {c2: float(np.mean([np.abs(by_class_imgs[c2] - r[None]).mean(axis=(1, 2)).min() for r in raw]))
              for c2 in CLASSES}
        own = nn[c]
        other = min(v for k2, v in nn.items() if k2 != c)
        report[c] = {"own_nn_mae": round(own, 2), "best_other_nn_mae": round(other, 2), "selective": bool(own < other)}

    grid_path = os.path.join(a.work, "cond_selectivity_grid.png")
    Image.fromarray(np.concatenate(grid_rows, axis=0)).save(grid_path)
    n_sel = sum(r["selective"] for r in report.values())
    losses = unet_result["losses"]
    window = min(LOSS_WINDOW, len(losses))  # one step's loss swings with its random timesteps
    result = {"selective_classes": f"{n_sel}/{len(CLASSES)}", "per_class": report, "grid": grid_path,
              "device": str(device), "files": sum(len(f) for f in files_by_class.values()), "vae": vae_result,
              "unet": {"steps": unet_result["steps"], "seconds": unet_result["seconds"],
                       "loss_first": losses[0], "loss_last": losses[-1], "loss_window": window,
                       "loss_first_mean": float(np.mean(losses[:window])),
                       "loss_last_mean": float(np.mean(losses[-window:]))}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
