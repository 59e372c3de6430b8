"""Convert checkpoints between the on-disk layouts (port of
``scripts/convert_checkpoint.py``), both directions:

    # either layout -> the JAX package's native layout (params.msgpack)
    python -m audio_diffusion_torch.scripts.convert_checkpoint --input DIR --output OUT --to native

    # either layout -> the torch diffusers layout (diffusion_pytorch_model.bin)
    python -m audio_diffusion_torch.scripts.convert_checkpoint --input DIR --output OUT --to torch

The source layout is detected per model directory. A pipeline trained with
the JAX package on a TPU and saved with its ``save_pretrained`` is served by
the port as it is, and ``--to torch`` turns it into the layout the
reference stack reads; a pipeline the port trained goes back with
``--to native``. The weights move unchanged (a round trip is bitwise).

Also converts a CompVis latent-diffusion VAE checkpoint (the reference's
train_vae.py output: a Lightning ``.ckpt`` and its yaml config) into a VAE
directory, which the port's pipeline and trainer (``--vae``) read
(reference: audiodiffusion/utils.py:294-303); it writes the diffusers layout
unless ``--to native`` is given:

    python -m audio_diffusion_torch.scripts.convert_checkpoint --input last.ckpt \\
        --ldm_config config/ldm_autoencoder_kl.yaml --output models/vae_dir
"""

import argparse

import torch

from ..models.vae import AutoencoderKL
from ..pipelines.pipeline import AudioDiffusionPipeline
from ..utils import diffusers_io
from ..utils.ldm_import import ldm_vae_to_diffusers, vae_config_from_ldm

LAYOUT = {"native": "native", "torch": "diffusers"}  # --to -> save_pretrained's layout


def convert_ldm_checkpoint(ckpt_path: str, ldm_config_path: str, output: str, layout: str = "diffusers") -> dict:
    """Lightning LDM VAE .ckpt + yaml config -> a VAE directory in ``layout``,
    loaded strict=True on the way."""
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
    diffusers_io.write_vae(vae, output, layout)
    return {"output": output, "format": f"{layout}-vae", "vae_params": sum(p.numel() for p in vae.parameters())}


def convert_pipeline(input_dir: str, output: str, to: str) -> dict:
    """A pipeline directory in either layout -> ``output`` in ``to`` ("native" or "torch")."""
    source = "native" if diffusers_io.is_native(f"{input_dir}/unet") else "torch"
    pipe = AudioDiffusionPipeline.from_pretrained(input_dir, device="cpu")
    pipe.save_pretrained(output, layout=LAYOUT[to])
    return {"output": output, "format": to, "from": source,
            "unet_params": sum(p.numel() for p in pipe.unet.parameters()), "latent": pipe.vqvae is not None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", type=str, required=True,
                   help="source pipeline directory, or an LDM VAE .ckpt with --ldm_config")
    p.add_argument("--output", type=str, required=True, help="destination directory")
    p.add_argument("--to", type=str, default=None, choices=sorted(LAYOUT),
                   help="output layout (default: native for a pipeline, torch for an LDM .ckpt; "
                        "the source layout is detected)")
    p.add_argument("--ldm_config", type=str, default=None,
                   help="LDM yaml config (model.params.ddconfig) for .ckpt inputs")
    a = p.parse_args(argv)
    if a.ldm_config is not None or a.input.endswith(".ckpt"):
        if a.ldm_config is None:
            p.error("--ldm_config is required for LDM .ckpt inputs")
        result = convert_ldm_checkpoint(a.input, a.ldm_config, a.output, LAYOUT[a.to or "torch"])
    else:
        result = convert_pipeline(a.input, a.output, a.to or "native")
    print(result)
    return result


if __name__ == "__main__":
    main()
