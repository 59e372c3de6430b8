"""The diffusers on-disk layout of the port's UNet and VAE: configs and weights.

A copy of the layout parts of ``audio_diffusion_tpu/utils/torch_export.py``
(``unet_config_to_diffusers``, ``vae_config_to_diffusers``,
torch_export.py:152-231) and ``torch_import.py`` (``unet_config_from_diffusers``,
``vae_config_from_diffusers``, torch_import.py:222-299), so a directory that
either package writes loads in the other. The port's state-dict keys already
are the diffusers keys (``utils/convert.py``), so weights need no mapping
beyond squeezing 1x1-conv projections (:func:`linear_from_conv1x1`):
``diffusion_pytorch_model.bin`` is written with ``torch.save`` and read with
``torch.load(weights_only=True)``. ``.safetensors`` weights need the
``safetensors`` package, which the port does not use: such a directory raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

DIFFUSERS_VERSION = "0.24.0"
WEIGHTS_NAME = "diffusion_pytorch_model.bin"


def unet_config_to_diffusers(config) -> dict:
    cfg = {
        "_class_name": "UNet2DConditionModel" if config.is_conditional else "UNet2DModel",
        "_diffusers_version": DIFFUSERS_VERSION,
        "sample_size": list(config.sample_hw()),
        "in_channels": config.in_channels,
        "out_channels": config.out_channels,
        "layers_per_block": config.layers_per_block,
        "block_out_channels": list(config.block_out_channels),
        "down_block_types": list(config.down_block_types),
        "up_block_types": list(config.up_block_types),
        "attention_head_dim": config.attention_head_dim,
        "norm_num_groups": config.norm_num_groups,
        "norm_eps": config.norm_eps,
        "flip_sin_to_cos": config.flip_sin_to_cos,
        "freq_shift": config.freq_shift,
    }
    if config.is_conditional:
        cfg["cross_attention_dim"] = config.cross_attention_dim
        cfg["use_linear_projection"] = True
        cfg["mid_block_type"] = "UNetMidBlock2DCrossAttn"
    return cfg


def unet_config_from_diffusers(config: dict):
    """diffusers UNet config -> the port's ``UNetConfig``; ``dtype`` and
    ``fused_groupnorm`` are not in the file and take their defaults."""
    from ..models.unet2d import UNetConfig

    ss = config.get("sample_size", 256)
    if isinstance(ss, int):
        ss = (ss, ss)
    cross = config.get("cross_attention_dim")
    if config.get("_class_name") == "UNet2DConditionModel" and cross is None:
        cross = 1280
    return UNetConfig(
        sample_size=tuple(ss),
        in_channels=config.get("in_channels", 1),
        out_channels=config.get("out_channels", 1),
        layers_per_block=config.get("layers_per_block", 2),
        block_out_channels=tuple(config.get("block_out_channels", (128, 128, 256, 256, 512, 512))),
        down_block_types=tuple(config.get("down_block_types", ())),
        up_block_types=tuple(config.get("up_block_types", ())),
        attention_head_dim=config.get("attention_head_dim", 8) or 8,
        norm_num_groups=config.get("norm_num_groups", 32),
        norm_eps=config.get("norm_eps", 1e-5),
        cross_attention_dim=cross,
        flip_sin_to_cos=config.get("flip_sin_to_cos", True),
        freq_shift=config.get("freq_shift", 0),
    )


def vae_config_to_diffusers(config) -> dict:
    n = len(config.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": DIFFUSERS_VERSION,
        "in_channels": config.in_channels,
        "out_channels": config.out_channels,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "block_out_channels": list(config.block_out_channels),
        "layers_per_block": config.layers_per_block,
        "latent_channels": config.latent_channels,
        "norm_num_groups": config.norm_num_groups,
        "sample_size": config.sample_size,
        "scaling_factor": config.scaling_factor,
        "act_fn": "silu",
    }


def vae_config_from_diffusers(config: dict):
    """diffusers AutoencoderKL config -> the port's ``VAEConfig`` (``dtype`` at its default)."""
    from ..models.vae import VAEConfig

    ss = config.get("sample_size", 256)
    if isinstance(ss, (list, tuple)):
        ss = ss[0]
    return VAEConfig(
        in_channels=config.get("in_channels", 1),
        out_channels=config.get("out_channels", 1),
        block_out_channels=tuple(config.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=config.get("layers_per_block", 2),
        latent_channels=config.get("latent_channels", 1),
        sample_size=ss,
        norm_num_groups=config.get("norm_num_groups", 32),
        scaling_factor=config.get("scaling_factor", 0.18215),
    )


def write_json(obj: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2, sort_keys=True)


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def save_state_dict(module: torch.nn.Module, model_dir: str) -> None:
    """Write ``module``'s weights as ``diffusion_pytorch_model.bin`` (on the
    CPU; floating tensors as f32, integer buffers such as BatchNorm's
    ``num_batches_tracked`` as they are), through a temporary file and a
    rename, so an interrupted save leaves no truncated file behind."""
    os.makedirs(model_dir, exist_ok=True)
    sd = {k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype).contiguous()
          for k, v in module.state_dict().items()}
    path = os.path.join(model_dir, WEIGHTS_NAME)
    torch.save(sd, path + ".tmp")
    os.replace(path + ".tmp", path)


def linear_from_conv1x1(sd: Dict[str, torch.Tensor], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Squeeze (O, I, 1, 1) weights stored for what ``module`` holds as
    Linear (O, I): a conditional UNet saved with ``use_linear_projection:
    false`` keeps its Transformer2D ``proj_in``/``proj_out`` as 1x1 convs, as
    the JAX importer accepts (torch_import.py:60-64, :110-116)."""
    own = module.state_dict()
    return {k: v[:, :, 0, 0] if v.dim() == 4 and v.shape[2:] == (1, 1) and k in own and own[k].dim() == 2 else v
            for k, v in sd.items()}


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Read ``diffusion_pytorch_model.bin``; raise with the reason when the
    directory holds only ``.safetensors`` or no weights at all."""
    path = os.path.join(model_dir, WEIGHTS_NAME)
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    if os.path.exists(os.path.join(model_dir, "diffusion_pytorch_model.safetensors")):
        raise ValueError(f"{model_dir!r} holds only diffusion_pytorch_model.safetensors; the port reads "
                         f"{WEIGHTS_NAME} and does not use the safetensors package. Re-save the weights as "
                         f"{WEIGHTS_NAME} (torch.save of the state dict).")
    if os.path.exists(os.path.join(model_dir, "params.msgpack")):
        raise ValueError(f"{model_dir!r} is in the JAX package's native layout (params.msgpack); the port reads "
                         "the diffusers layout. Convert it with "
                         "audio_diffusion_tpu.utils.torch_export.save_pipeline_torch.")
    raise FileNotFoundError(f"no {WEIGHTS_NAME} in {model_dir!r}")
