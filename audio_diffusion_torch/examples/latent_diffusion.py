"""Latent diffusion end to end (reference: README.md's latent section and
notebooks/test_vae.ipynb; port of ``examples/latent_diffusion.py``): train a
KL-VAE, train a UNet over its latents, generate through the VAE decode.

Run: python -m audio_diffusion_torch.examples.latent_diffusion dataset-dir out-dir [--quick] [--device cpu]

The dataset comes from ``python -m audio_diffusion_torch.scripts.audio_to_images``
(or a folder of PNG slices); its size must keep the latents divisible by
2^(num_unet_blocks - 1), e.g. 256x256 images with the default VAE give 32x32
latents. --quick shrinks both trainings to a few steps on a small VAE for a
smoke test: the same trainers at a tiny budget, on a 64x64 dataset (the small
VAE downsamples once, to 32x32 latents).
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset")
    p.add_argument("out")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..ops.audio_io import normalize, write_wav
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..training.__main__ import main as train_unet
    from ..training.train_vae import main as train_vae

    vae_args = ["--max_epochs", "50"]
    unet_args = ["--train_batch_size", "2", "--gradient_accumulation_steps", "8", "--num_epochs", "100"]
    if a.quick:
        vae_args = ["--max_steps", "2", "--base_channels", "32", "--ch_mult", "1,2",
                    "--norm_num_groups", "8", "--disc_start", "1000000"]
        unet_args = ["--train_batch_size", "2", "--num_epochs", "1", "--max_steps", "2",
                     "--lr_warmup_steps", "1", "--save_images_epochs", "100000",
                     "--save_model_epochs", "100000"]
    vae_dir, model_dir = os.path.join(a.out, "vae"), os.path.join(a.out, "model")

    # 1. the adversarial KL-VAE (reference: scripts/train_vae.py's recipe)
    train_vae(["-d", a.dataset, "-b", "2", "--hf_checkpoint_dir", vae_dir, "--device", a.device, *vae_args])
    # 2. the UNet over the VAE's latents (reference: train_unet.py --vae)
    train_unet(["--dataset", a.dataset, "--vae", vae_dir, "--output_dir", model_dir, "--device", a.device,
                *unet_args])
    # 3. generate (the saved pipeline carries the vqvae)
    pipe = AudioDiffusionPipeline.from_pretrained(model_dir, device=a.device)
    if pipe.vqvae is None:
        raise SystemExit(f"{model_dir} holds no vqvae: the UNet was not trained over latents")
    result = pipe(batch_size=1, steps=5 if a.quick else 50,
                  generator=torch.Generator(device=pipe.device).manual_seed(42))
    result.images[0].save(os.path.join(a.out, "latent_sample.png"))
    write_wav(os.path.join(a.out, "latent_sample.wav"), normalize(result.audios[0]), result.sample_rate)
    print("wrote", os.path.join(a.out, "latent_sample.png"), os.path.join(a.out, "latent_sample.wav"))


if __name__ == "__main__":
    main()
