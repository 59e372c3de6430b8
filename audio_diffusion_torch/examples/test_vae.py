"""VAE reconstruct / random sample / latent slerp (reference:
notebooks/test_vae.ipynb; port of ``examples/test_vae.py``).

Run: python -m audio_diffusion_torch.examples.test_vae vae-dir dataset-dir [--device cpu]
(the VAE directory in either layout: the port's ``train_vae`` output, or the
JAX package's ``params.msgpack``)
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("vae_dir")
    p.add_argument("dataset_dir")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch
    from PIL import Image

    from ..data.dataset import ImageSliceDataset
    from ..models.vae import AutoencoderKL
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..utils import diffusers_io

    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("test_vae: CUDA device requested but torch.cuda is not available; pass --device cpu")
    config, state_dict = diffusers_io.read_vae(a.vae_dir)
    vae = AutoencoderKL(config)
    vae.load_state_dict(state_dict, strict=True)
    vae = vae.to(a.device).eval()

    def seed(n):
        return torch.Generator(device=a.device).manual_seed(n)

    def image(i):
        img = ds.get(i)["image"].astype(np.float32) / 255.0 * 2 - 1
        return torch.from_numpy(img)[None, ..., None].to(a.device)

    def save(x, path):
        Image.fromarray((np.clip(x.float().cpu().numpy()[0, ..., 0] / 2 + 0.5, 0, 1) * 255).astype(np.uint8)).save(path)

    ds = ImageSliceDataset(a.dataset_dir)
    with torch.inference_mode():
        x = image(0)
        # Reconstruct.
        posterior = vae.encode(x)
        save(vae.decode(posterior.sample(seed(1))), "vae_rec.png")
        # Random sample from the prior.
        z = torch.randn(posterior.mean.shape, generator=seed(2), device=a.device)
        save(vae.decode(z), "vae_sample.png")
        # Latent slerp between two images.
        z1 = vae.encode(x).sample(seed(3))
        z2 = vae.encode(image(min(1, len(ds) - 1))).sample(seed(4))
        save(vae.decode(AudioDiffusionPipeline.slerp(z1, z2, 0.5)), "vae_slerp.png")
    print("wrote vae_rec.png vae_sample.png vae_slerp.png")


if __name__ == "__main__":
    main()
