"""flax parameter trees <-> state dicts of the port's models (numpy only).

The layout rules of ``audio_diffusion_tpu/utils/torch_export.py``
(torch_export.py:73-149, 181-212): conv kernels HWIO -> OIHW, dense kernels
(I, O) -> (O, I), norm ``scale`` -> ``weight``, self-attention ``to_out`` ->
``to_out.0``, diffusers key names. The result is a dict of f32 numpy arrays;
``load_state_dict`` takes it through :func:`to_torch`. Conditional
``Transformer2D`` projections are Linear (``use_linear_projection``), as the
JAX export writes them. :func:`audio_encoder_state_dict` is the inverse of
``torch_import.py::convert_audio_encoder`` (torch_import.py:414-441).
:func:`discriminator_state_dict` and :func:`perceptual_params` carry the VAE
trainer's PatchGAN and fixed perceptual features over (``training/train_vae.py``,
``training/perceptual.py``).

The inverse, :func:`unet_params_from_state_dict` and
:func:`vae_params_from_state_dict`, is the port's copy of
``torch_import.py::convert_unet`` / ``convert_vae`` (torch_import.py:176-221,
:247-283): OIHW -> HWIO, (O, I) -> (I, O), 1x1-conv projections squeezed,
the old ``AttentionBlock`` names read as aliases. Its result is checked key by
key and shape by shape against the port's own module (``_check_structure``,
the counterpart of torch_import.py:459-479). Both directions move the arrays
unchanged, so a round trip is bitwise.
"""

from __future__ import annotations

from typing import Dict, List, Set

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


def _cross_attention(sd: dict, prefix: str, p: dict) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{prefix}.{name}", p[name])
    _dense(sd, f"{prefix}.to_out.0", p["to_out"])


def _feed_forward(sd: dict, prefix: str, p: dict) -> None:
    _dense(sd, f"{prefix}.net.0.proj", p["proj_in"])
    _dense(sd, f"{prefix}.net.2", p["proj_out"])


def _transformer_block(sd: dict, prefix: str, p: dict) -> None:
    for i in (1, 2, 3):
        _norm(sd, f"{prefix}.norm{i}", p[f"norm{i}"])
    _cross_attention(sd, f"{prefix}.attn1", p["attn1"])
    _cross_attention(sd, f"{prefix}.attn2", p["attn2"])
    _feed_forward(sd, f"{prefix}.ff", p["ff"])


def _transformer2d(sd: dict, prefix: str, p: dict) -> None:
    _norm(sd, f"{prefix}.norm", p["norm"])
    _dense(sd, f"{prefix}.proj_in", p["proj_in"])
    _dense(sd, f"{prefix}.proj_out", p["proj_out"])
    _transformer_block(sd, f"{prefix}.transformer_blocks.0", p["transformer_blocks_0"])


def unet_state_dict(params: dict, config) -> Dict[str, np.ndarray]:
    """flax ``UNet2D`` params -> ``models.unet2d.UNet2D`` state dict."""
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
            elif block_type == "CrossAttnDownBlock2D":
                _transformer2d(sd, f"down_blocks.{i}.attentions.{j}", params[f"down_{i}_xattn_{j}"])
        if i != n_blocks - 1:
            _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", params[f"down_{i}_downsample"]["conv"])

    _resnet(sd, "mid_block.resnets.0", params["mid_res_0"])
    _resnet(sd, "mid_block.resnets.1", params["mid_res_1"])
    if config.is_conditional:
        _transformer2d(sd, "mid_block.attentions.0", params["mid_xattn"])
    else:
        _self_attention(sd, "mid_block.attentions.0", params["mid_attn"])

    for i, block_type in enumerate(config.up_block_types):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", params[f"up_{i}_res_{j}"])
            if block_type == "AttnUpBlock2D":
                _self_attention(sd, f"up_blocks.{i}.attentions.{j}", params[f"up_{i}_attn_{j}"])
            elif block_type == "CrossAttnUpBlock2D":
                _transformer2d(sd, f"up_blocks.{i}.attentions.{j}", params[f"up_{i}_xattn_{j}"])
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


def _batch_norm(sd: dict, name: str, p: dict, stats: dict) -> None:
    _norm(sd, name, p)
    _put(sd, f"{name}.running_mean", stats["mean"])
    _put(sd, f"{name}.running_var", stats["var"])
    sd[f"{name}.num_batches_tracked"] = np.array(0, dtype=np.int64)  # a torch buffer flax does not keep


def audio_encoder_state_dict(variables: dict) -> Dict[str, np.ndarray]:
    """flax ``AudioEncoder`` variables ``{params, batch_stats}`` -> the
    reference's (and ``models.audio_encoder.AudioEncoder``'s) state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    n_blocks = sum(k.startswith("conv_block_") for k in params)
    for i in range(n_blocks):
        p, prefix = params[f"conv_block_{i}"], f"conv_blocks.{i}"
        _conv(sd, f"{prefix}.sep_conv.depthwise", p["sep_conv"]["depthwise"])  # (3, 3, 1, C) -> (C, 1, 3, 3)
        _conv(sd, f"{prefix}.sep_conv.pointwise", p["sep_conv"]["pointwise"])
        _batch_norm(sd, f"{prefix}.batch_norm", p["batch_norm"], stats[f"conv_block_{i}"]["batch_norm"])
    _dense(sd, "dense_block.dense", params["dense"])
    _batch_norm(sd, "dense_block.batch_norm", params["dense_norm"], stats["dense_norm"])
    _dense(sd, "embedding", params["embedding"])
    return sd


def discriminator_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """flax ``PatchDiscriminator`` params -> ``training.train_vae.PatchDiscriminator`` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "conv_in", params["conv_in"])
    i = 1
    while f"conv_{i}" in params:
        _conv(sd, f"conv_{i}", params[f"conv_{i}"])
        _norm(sd, f"norm_{i}", params[f"norm_{i}"])
        i += 1
    _conv(sd, "conv_last", params["conv_last"])
    _norm(sd, "norm_last", params["norm_last"])
    _conv(sd, "conv_out", params["conv_out"])
    return sd


def perceptual_params(params) -> List[List[np.ndarray]]:
    """``perceptual.init_perceptual_params``'s HWIO kernels -> the port's OIHW, stage by stage."""
    return [[np.ascontiguousarray(np.transpose(np.asarray(w, dtype=np.float32), (3, 2, 0, 1))) for w in stage]
            for stage in params]


# ------------------------------------------------------ state dict -> flax

class _SD:
    """State-dict view with prefix scoping and the old diffusers attention
    names as aliases; records the keys it reads, so unread keys show."""

    ALIASES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}

    def __init__(self, sd, prefix: str = "", used: Set[str] | None = None):
        self.sd, self.prefix = sd, prefix
        self.used = set() if used is None else used

    def scope(self, name: str) -> "_SD":
        return _SD(self.sd, f"{self.prefix}{name}.", self.used)

    def _key(self, key: str):
        full = self.prefix + key
        if full in self.sd:
            return full
        for new, old in self.ALIASES.items():
            if key.startswith(new):
                alt = self.prefix + key.replace(new, old, 1)
                if alt in self.sd:
                    return alt
        return None

    def get(self, key: str) -> np.ndarray:
        full = self._key(key)
        if full is None:
            raise KeyError(self.prefix + key)
        self.used.add(full)
        return np.asarray(self.sd[full])

    def has(self, key: str) -> bool:
        return self._key(key) is not None


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _dense_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w[:, :, 0, 0] if w.ndim == 4 else w, (1, 0))  # a 1x1 conv projection squeezes


def _get_norm(sd: _SD, name: str) -> dict:
    return {"scale": sd.get(f"{name}.weight"), "bias": sd.get(f"{name}.bias")}


def _get_conv(sd: _SD, name: str) -> dict:
    out = {"kernel": _conv_kernel(sd.get(f"{name}.weight"))}
    if sd.has(f"{name}.bias"):
        out["bias"] = sd.get(f"{name}.bias")
    return out


def _get_dense(sd: _SD, name: str) -> dict:
    out = {"kernel": _dense_kernel(sd.get(f"{name}.weight"))}
    if sd.has(f"{name}.bias"):
        out["bias"] = sd.get(f"{name}.bias")
    return out


def _get_resnet(sd: _SD) -> dict:
    out = {"norm1": _get_norm(sd, "norm1"), "conv1": _get_conv(sd, "conv1"),
           "norm2": _get_norm(sd, "norm2"), "conv2": _get_conv(sd, "conv2")}
    if sd.has("time_emb_proj.weight"):
        out["time_emb_proj"] = _get_dense(sd, "time_emb_proj")
    if sd.has("conv_shortcut.weight"):
        out["conv_shortcut"] = _get_conv(sd, "conv_shortcut")
    elif sd.has("nin_shortcut.weight"):
        out["conv_shortcut"] = _get_conv(sd, "nin_shortcut")
    return out


def _get_self_attention(sd: _SD) -> dict:
    return {"group_norm": _get_norm(sd, "group_norm"), **_get_cross_attention(sd)}


def _get_cross_attention(sd: _SD) -> dict:
    return {"to_q": _get_dense(sd, "to_q"), "to_k": _get_dense(sd, "to_k"), "to_v": _get_dense(sd, "to_v"),
            "to_out": _get_dense(sd, "to_out.0")}


def _get_transformer2d(sd: _SD) -> dict:
    blk = sd.scope("transformer_blocks.0")
    return {
        "norm": _get_norm(sd, "norm"),
        "proj_in": _get_dense(sd, "proj_in"),
        "proj_out": _get_dense(sd, "proj_out"),
        "transformer_blocks_0": {
            "norm1": _get_norm(blk, "norm1"),
            "attn1": _get_cross_attention(blk.scope("attn1")),
            "norm2": _get_norm(blk, "norm2"),
            "attn2": _get_cross_attention(blk.scope("attn2")),
            "norm3": _get_norm(blk, "norm3"),
            "ff": {"proj_in": _get_dense(blk, "ff.net.0.proj"), "proj_out": _get_dense(blk, "ff.net.2")},
        },
    }


def _port_shapes(module_cls, config) -> Dict[str, tuple]:
    """The keys and shapes of the port's own module for ``config``, built on
    the meta device (no memory, no init)."""
    import torch

    with torch.device("meta"):
        module = module_cls(config)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _check_structure(sd: _SD, params: dict, expected: Dict[str, tuple], forward) -> dict:
    """Every key of the state dict was read, and the tree maps back onto
    exactly the port's keys and shapes (``expected``)."""
    unread = sorted(set(sd.sd) - sd.used)
    if unread:
        raise ValueError(f"state dict keys the port's module does not have: {unread[:5]}")
    got = {k: np.shape(v) for k, v in forward(params).items()}
    missing, extra = sorted(set(expected) - set(got)), sorted(set(got) - set(expected))
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing={missing[:5]} extra={extra[:5]}")
    for k, shape in expected.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"shape mismatch at {k}: {tuple(got[k])} vs expected {shape}")
    return params


def unet_params_from_state_dict(sd_raw, config) -> dict:
    """``models.unet2d.UNet2D`` state dict (numpy arrays or tensors on the
    CPU; the diffusers keys) -> flax ``UNet2D`` params, the JAX package's tree."""
    from ..models.unet2d import UNet2D

    sd = _SD({k: np.asarray(v) for k, v in sd_raw.items()})
    params = {
        "time_embedding": {"linear_1": _get_dense(sd, "time_embedding.linear_1"),
                           "linear_2": _get_dense(sd, "time_embedding.linear_2")},
        "conv_in": _get_conv(sd, "conv_in"),
        "conv_norm_out": _get_norm(sd, "conv_norm_out"),
        "conv_out": _get_conv(sd, "conv_out"),
    }
    n_blocks = len(config.block_out_channels)
    for i, block_type in enumerate(config.down_block_types):
        blk = sd.scope(f"down_blocks.{i}")
        for j in range(config.layers_per_block):
            params[f"down_{i}_res_{j}"] = _get_resnet(blk.scope(f"resnets.{j}"))
            if block_type == "AttnDownBlock2D":
                params[f"down_{i}_attn_{j}"] = _get_self_attention(blk.scope(f"attentions.{j}"))
            elif block_type == "CrossAttnDownBlock2D":
                params[f"down_{i}_xattn_{j}"] = _get_transformer2d(blk.scope(f"attentions.{j}"))
        if i != n_blocks - 1:
            params[f"down_{i}_downsample"] = {"conv": _get_conv(blk, "downsamplers.0.conv")}

    mid = sd.scope("mid_block")
    params["mid_res_0"] = _get_resnet(mid.scope("resnets.0"))
    params["mid_res_1"] = _get_resnet(mid.scope("resnets.1"))
    if config.is_conditional:
        params["mid_xattn"] = _get_transformer2d(mid.scope("attentions.0"))
    else:
        params["mid_attn"] = _get_self_attention(mid.scope("attentions.0"))

    for i, block_type in enumerate(config.up_block_types):
        blk = sd.scope(f"up_blocks.{i}")
        for j in range(config.layers_per_block + 1):
            params[f"up_{i}_res_{j}"] = _get_resnet(blk.scope(f"resnets.{j}"))
            if block_type == "AttnUpBlock2D":
                params[f"up_{i}_attn_{j}"] = _get_self_attention(blk.scope(f"attentions.{j}"))
            elif block_type == "CrossAttnUpBlock2D":
                params[f"up_{i}_xattn_{j}"] = _get_transformer2d(blk.scope(f"attentions.{j}"))
        if i != n_blocks - 1:
            params[f"up_{i}_upsample"] = {"conv": _get_conv(blk, "upsamplers.0.conv")}
    return _check_structure(sd, params, _port_shapes(UNet2D, config), lambda p: unet_state_dict(p, config))


def _get_vae_coder(sd: _SD, config, is_encoder: bool) -> dict:
    n_blocks = len(config.block_out_channels)
    out = {
        "conv_in": _get_conv(sd, "conv_in"),
        "conv_norm_out": _get_norm(sd, "conv_norm_out"),
        "conv_out": _get_conv(sd, "conv_out"),
        "mid_res_0": _get_resnet(sd.scope("mid_block.resnets.0")),
        "mid_attn": _get_self_attention(sd.scope("mid_block.attentions.0")),
        "mid_res_1": _get_resnet(sd.scope("mid_block.resnets.1")),
    }
    for i in range(n_blocks):
        if is_encoder:
            blk = sd.scope(f"down_blocks.{i}")
            for j in range(config.layers_per_block):
                out[f"down_{i}_res_{j}"] = _get_resnet(blk.scope(f"resnets.{j}"))
            if i != n_blocks - 1:
                out[f"down_{i}_downsample"] = _get_conv(blk, "downsamplers.0.conv")
        else:
            blk = sd.scope(f"up_blocks.{i}")
            for j in range(config.layers_per_block + 1):
                out[f"up_{i}_res_{j}"] = _get_resnet(blk.scope(f"resnets.{j}"))
            if i != n_blocks - 1:
                out[f"up_{i}_upsample"] = _get_conv(blk, "upsamplers.0.conv")
    return out


def vae_params_from_state_dict(sd_raw, config) -> dict:
    """``models.vae.AutoencoderKL`` state dict -> flax ``AutoencoderKL`` params."""
    from ..models.vae import AutoencoderKL

    sd = _SD({k: np.asarray(v) for k, v in sd_raw.items()})
    params = {
        "encoder": _get_vae_coder(sd.scope("encoder"), config, is_encoder=True),
        "decoder": _get_vae_coder(sd.scope("decoder"), config, is_encoder=False),
        "quant_conv": _get_conv(sd, "quant_conv"),
        "post_quant_conv": _get_conv(sd, "post_quant_conv"),
    }
    return _check_structure(sd, params, _port_shapes(AutoencoderKL, config), lambda p: vae_state_dict(p, config))


def to_torch(sd: Dict[str, np.ndarray]) -> dict:
    """numpy state dict -> tensors for ``module.load_state_dict(..., strict=True)``."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).reshape(np.shape(v)) for k, v in sd.items()}
