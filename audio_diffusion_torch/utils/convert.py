"""flax parameter trees -> state dicts of the port's models (numpy only).

The layout rules of ``audio_diffusion_tpu/utils/torch_export.py``
(torch_export.py:73-149, 181-212): conv kernels HWIO -> OIHW, dense kernels
(I, O) -> (O, I), norm ``scale`` -> ``weight``, self-attention ``to_out`` ->
``to_out.0``, diffusers key names. The result is a dict of f32 numpy arrays;
``load_state_dict`` takes it through :func:`to_torch`. Cross-attention
(conditional) trees wait for ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _put(sd: dict, key: str, value) -> None:
    sd[key] = np.asarray(value, dtype=np.float32)


def _conv(sd: dict, name: str, p: dict) -> None:
    _put(sd, f"{name}.weight", np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        _put(sd, f"{name}.bias", p["bias"])


def _dense(sd: dict, name: str, p: dict) -> None:
    _put(sd, f"{name}.weight", np.transpose(np.asarray(p["kernel"]), (1, 0)))
    if "bias" in p:
        _put(sd, f"{name}.bias", p["bias"])


def _norm(sd: dict, name: str, p: dict) -> None:
    _put(sd, f"{name}.weight", p["scale"])
    _put(sd, f"{name}.bias", p["bias"])


def _resnet(sd: dict, prefix: str, p: dict) -> None:
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _dense(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def _self_attention(sd: dict, prefix: str, p: dict) -> None:
    _norm(sd, f"{prefix}.group_norm", p["group_norm"])
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{prefix}.{name}", p[name])
    _dense(sd, f"{prefix}.to_out.0", p["to_out"])


def unet_state_dict(params: dict, config) -> Dict[str, np.ndarray]:
    """flax ``UNet2D`` params (unconditional) -> ``models.unet2d.UNet2D`` state dict."""
    if config.is_conditional:
        raise NotImplementedError("conditional UNet conversion waits for ROADMAP Queue 1 item 9")
    sd: Dict[str, np.ndarray] = {}
    _dense(sd, "time_embedding.linear_1", params["time_embedding"]["linear_1"])
    _dense(sd, "time_embedding.linear_2", params["time_embedding"]["linear_2"])
    _conv(sd, "conv_in", params["conv_in"])
    _norm(sd, "conv_norm_out", params["conv_norm_out"])
    _conv(sd, "conv_out", params["conv_out"])

    n_blocks = len(config.block_out_channels)
    for i, block_type in enumerate(config.down_block_types):
        for j in range(config.layers_per_block):
            _resnet(sd, f"down_blocks.{i}.resnets.{j}", params[f"down_{i}_res_{j}"])
            if block_type == "AttnDownBlock2D":
                _self_attention(sd, f"down_blocks.{i}.attentions.{j}", params[f"down_{i}_attn_{j}"])
        if i != n_blocks - 1:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", params[f"down_{i}_downsample"]["conv"])

    _resnet(sd, "mid_block.resnets.0", params["mid_res_0"])
    _resnet(sd, "mid_block.resnets.1", params["mid_res_1"])
    _self_attention(sd, "mid_block.attentions.0", params["mid_attn"])

    for i, block_type in enumerate(config.up_block_types):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", params[f"up_{i}_res_{j}"])
            if block_type == "AttnUpBlock2D":
                _self_attention(sd, f"up_blocks.{i}.attentions.{j}", params[f"up_{i}_attn_{j}"])
        if i != n_blocks - 1:
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv", params[f"up_{i}_upsample"]["conv"])
    return sd


def _vae_coder(sd: dict, prefix: str, params: dict, config, is_encoder: bool) -> None:
    _conv(sd, f"{prefix}.conv_in", params["conv_in"])
    _norm(sd, f"{prefix}.conv_norm_out", params["conv_norm_out"])
    _conv(sd, f"{prefix}.conv_out", params["conv_out"])
    _resnet(sd, f"{prefix}.mid_block.resnets.0", params["mid_res_0"])
    _self_attention(sd, f"{prefix}.mid_block.attentions.0", params["mid_attn"])
    _resnet(sd, f"{prefix}.mid_block.resnets.1", params["mid_res_1"])

    n_blocks = len(config.block_out_channels)
    for i in range(n_blocks):
        if is_encoder:
            for j in range(config.layers_per_block):
                _resnet(sd, f"{prefix}.down_blocks.{i}.resnets.{j}", params[f"down_{i}_res_{j}"])
            if i != n_blocks - 1:
                _conv(sd, f"{prefix}.down_blocks.{i}.downsamplers.0.conv", params[f"down_{i}_downsample"])
        else:
            for j in range(config.layers_per_block + 1):
                _resnet(sd, f"{prefix}.up_blocks.{i}.resnets.{j}", params[f"up_{i}_res_{j}"])
            if i != n_blocks - 1:
                _conv(sd, f"{prefix}.up_blocks.{i}.upsamplers.0.conv", params[f"up_{i}_upsample"])


def vae_state_dict(params: dict, config) -> Dict[str, np.ndarray]:
    """flax ``AutoencoderKL`` params -> ``models.vae.AutoencoderKL`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _vae_coder(sd, "encoder", params["encoder"], config, is_encoder=True)
    _vae_coder(sd, "decoder", params["decoder"], config, is_encoder=False)
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def to_torch(sd: Dict[str, np.ndarray]) -> dict:
    """numpy state dict -> tensors for ``module.load_state_dict(..., strict=True)``."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
