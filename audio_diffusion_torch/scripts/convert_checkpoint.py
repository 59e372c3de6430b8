"""Convert a CompVis latent-diffusion VAE checkpoint (the reference's
train_vae.py output: a Lightning ``.ckpt`` and its yaml config) into a
diffusers-layout VAE directory, which the port's pipeline and trainer
(``--vae``) read (port of ``scripts/convert_checkpoint.py::convert_ldm_checkpoint``;
reference: audiodiffusion/utils.py:294-303).

    python -m audio_diffusion_torch.scripts.convert_checkpoint --input last.ckpt \\
        --ldm_config config/ldm_autoencoder_kl.yaml --output models/vae_dir

The JAX script's pipeline directions (``--to native|torch``) read or write the
JAX-native ``params.msgpack`` layout, which this package does not use.
"""

import argparse
import os

import torch

from ..models.vae import AutoencoderKL
from ..utils import diffusers_io
from ..utils.ldm_import import ldm_vae_to_diffusers, vae_config_from_ldm


def convert_ldm_checkpoint(ckpt_path: str, ldm_config_path: str, output: str) -> dict:
    """Lightning LDM VAE .ckpt + yaml config -> diffusers-layout VAE directory
    (config.json + diffusion_pytorch_model.bin), loaded strict=True on the way."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading the LDM yaml config needs the `pyyaml` package, which is not installed") from e

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    with open(ldm_config_path) as fh:
        ddconfig = yaml.safe_load(fh)["model"]["params"]["ddconfig"]

    config = vae_config_from_ldm(ddconfig)
    vae = AutoencoderKL(config)
    vae.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in ldm_vae_to_diffusers(sd).items()}, strict=True)
    diffusers_io.write_json(diffusers_io.vae_config_to_diffusers(config), os.path.join(output, "config.json"))
    diffusers_io.save_state_dict(vae, output)
    return {"output": output, "format": "diffusers-vae", "vae_params": sum(p.numel() for p in vae.parameters())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", type=str, required=True, help="an LDM VAE .ckpt")
    p.add_argument("--output", type=str, required=True, help="destination directory")
    p.add_argument("--ldm_config", type=str, required=True, help="LDM yaml config (model.params.ddconfig)")
    a = p.parse_args(argv)
    result = convert_ldm_checkpoint(a.input, a.ldm_config, a.output)
    print(result)
    return result


if __name__ == "__main__":
    main()
