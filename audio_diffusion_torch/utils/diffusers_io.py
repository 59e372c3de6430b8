"""The on-disk layouts of the port's UNet and VAE: configs and weights.

Two layouts, as the JAX package reads them:

- **diffusers**: ``config.json`` in diffusers' names and
  ``diffusion_pytorch_model.bin`` (or ``.safetensors``). A copy of the layout
  parts of ``audio_diffusion_tpu/utils/torch_export.py``
  (``unet_config_to_diffusers``, ``vae_config_to_diffusers``,
  torch_export.py:152-231) and ``torch_import.py`` (``unet_config_from_diffusers``,
  ``vae_config_from_diffusers``, torch_import.py:222-299). The port's
  state-dict keys already are the diffusers keys (``utils/convert.py``), so
  weights need no mapping beyond squeezing 1x1-conv projections
  (:func:`linear_from_conv1x1`). ``.bin`` is written with ``torch.save`` and
  read with ``torch.load(weights_only=True)``; ``.safetensors`` is read by
  :mod:`.safetensors_io`.
- **native**: the JAX package's own ``save_pretrained`` layout
  (pipelines/pipeline.py:666-702): ``config.json`` is the config dataclass's
  own JSON and ``params.msgpack`` the flax parameter tree
  (:mod:`.flax_msgpack`), converted by ``utils/convert.py``.

Every weights file is written through a temporary file, an fsync and a
rename, so an interrupted save leaves no truncated file behind.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict

import torch

from . import convert, flax_msgpack, safetensors_io

DIFFUSERS_VERSION = "0.24.0"
WEIGHTS_NAME = "diffusion_pytorch_model.bin"
SAFETENSORS_NAME = "diffusion_pytorch_model.safetensors"
NATIVE_NAME = "params.msgpack"
LAYOUTS = ("diffusers", "native")


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
    if config.remat:  # not a diffusers key (diffusers ignores it): the JAX package's from_pretrained reads it
        cfg["remat"] = True
    return cfg


def unet_config_from_diffusers(config: dict):
    """diffusers UNet config -> the port's ``UNetConfig``; ``dtype`` and
    ``fused_groupnorm`` are not in the file and take their defaults, and
    ``remat`` is read where :func:`unet_config_to_diffusers` wrote it."""
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
        remat=config.get("remat", False),
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


def write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` through ``path.tmp``, an fsync and a rename (the JAX
    package's ``_write_atomic``, pipeline.py:666-675)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def cpu_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state on the CPU: floating tensors as f32, integer buffers
    such as BatchNorm's ``num_batches_tracked`` as they are."""
    return {k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype).contiguous()
            for k, v in module.state_dict().items()}


def save_state_dict(module: torch.nn.Module, model_dir: str) -> None:
    """Write ``module``'s weights as ``diffusion_pytorch_model.bin``."""
    os.makedirs(model_dir, exist_ok=True)
    buf = io.BytesIO()
    torch.save(cpu_state_dict(module), buf)
    write_atomic(os.path.join(model_dir, WEIGHTS_NAME), buf.getvalue())


def linear_from_conv1x1(sd: Dict[str, torch.Tensor], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Squeeze (O, I, 1, 1) weights stored for what ``module`` holds as
    Linear (O, I): a conditional UNet saved with ``use_linear_projection:
    false`` keeps its Transformer2D ``proj_in``/``proj_out`` as 1x1 convs, as
    the JAX importer accepts (torch_import.py:60-64, :110-116)."""
    own = module.state_dict()
    return {k: v[:, :, 0, 0] if v.dim() == 4 and v.shape[2:] == (1, 1) and k in own and own[k].dim() == 2 else v
            for k, v in sd.items()}


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Read ``diffusion_pytorch_model.safetensors``, else ``.bin``, the order
    of ``torch_import.load_torch_state_dict`` (torch_import.py:31-50)."""
    st_path, bin_path = os.path.join(model_dir, SAFETENSORS_NAME), os.path.join(model_dir, WEIGHTS_NAME)
    if os.path.exists(st_path):
        return {k: torch.from_numpy(v) for k, v in safetensors_io.load_file(st_path).items()}
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no {SAFETENSORS_NAME}, {WEIGHTS_NAME} or {NATIVE_NAME} in {model_dir!r}")


def is_native(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, NATIVE_NAME))


def read_unet(unet_dir: str):
    """(UNetConfig, state dict) of a UNet directory in either layout. A native
    config carries ``dtype`` and ``fused_groupnorm``; a diffusers one neither."""
    from ..models.unet2d import UNetConfig

    if is_native(unet_dir):
        config = UNetConfig.from_pretrained(unet_dir)
        params = flax_msgpack.load(os.path.join(unet_dir, NATIVE_NAME))
        return config, convert.to_torch(convert.unet_state_dict(params, config))
    return unet_config_from_diffusers(read_json(os.path.join(unet_dir, "config.json"))), load_state_dict(unet_dir)


def read_vae(vae_dir: str):
    """(VAEConfig, state dict) of a VAE directory in either layout."""
    from ..models.vae import VAEConfig

    if is_native(vae_dir):
        config = VAEConfig.from_pretrained(vae_dir)
        params = flax_msgpack.load(os.path.join(vae_dir, NATIVE_NAME))
        return config, convert.to_torch(convert.vae_state_dict(params, config))
    return vae_config_from_diffusers(read_json(os.path.join(vae_dir, "config.json"))), load_state_dict(vae_dir)


def write_unet(unet: torch.nn.Module, unet_dir: str, layout: str) -> None:
    """``unet``'s config and weights in ``layout`` ("diffusers" or "native")."""
    if layout == "native":
        unet.config.save_config(unet_dir)
        params = convert.unet_params_from_state_dict(cpu_state_dict(unet), unet.config)
        write_atomic(os.path.join(unet_dir, NATIVE_NAME), flax_msgpack.to_bytes(params))
    else:
        write_json(unet_config_to_diffusers(unet.config), os.path.join(unet_dir, "config.json"))
        save_state_dict(unet, unet_dir)


def write_vae(vae: torch.nn.Module, vae_dir: str, layout: str) -> None:
    """``vae``'s config and weights in ``layout`` ("diffusers" or "native")."""
    if layout == "native":
        vae.config.save_config(vae_dir)
        params = convert.vae_params_from_state_dict(cpu_state_dict(vae), vae.config)
        write_atomic(os.path.join(vae_dir, NATIVE_NAME), flax_msgpack.to_bytes(params))
    else:
        write_json(vae_config_to_diffusers(vae.config), os.path.join(vae_dir, "config.json"))
        save_state_dict(vae, vae_dir)
