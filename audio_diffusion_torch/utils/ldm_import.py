"""CompVis LDM first-stage VAE checkpoints -> the diffusers layout (port of
``audio_diffusion_tpu/utils/torch_import.py::ldm_vae_to_diffusers`` and
``vae_config_from_ldm``).

The reference trains its VAE with latent-diffusion's Lightning trainer and
converts the checkpoint (reference: audiodiffusion/utils.py:294-303). These
are pure key renames on numpy arrays plus the 1x1-conv squeeze of the mid
attention's q/k/v/proj; ``scripts/convert_checkpoint.py`` writes the result
as a diffusers-layout VAE directory.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..models.vae import VAEConfig

_LDM_MID = (
    ("mid.block_1.", "mid_block.resnets.0."),
    ("mid.block_2.", "mid_block.resnets.1."),
    ("mid.attn_1.norm.", "mid_block.attentions.0.group_norm."),
    ("mid.attn_1.q.", "mid_block.attentions.0.to_q."),
    ("mid.attn_1.k.", "mid_block.attentions.0.to_k."),
    ("mid.attn_1.v.", "mid_block.attentions.0.to_v."),
    ("mid.attn_1.proj_out.", "mid_block.attentions.0.to_out.0."),
)


def ldm_vae_to_diffusers(sd_raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rewrite a CompVis LDM ``AutoencoderKL`` state dict into the diffusers
    key layout that the port's ``AutoencoderKL`` loads (``strict=True``).

    The native analog of the reference's torch-side rename
    (reference: audiodiffusion/utils.py:156-291). Mapping rules:
    training-only state (``loss.*`` — LPIPS net + discriminator) is dropped;
    decoder up-block indices flip (LDM counts ``up.{i}`` from the bottom,
    diffusers ``up_blocks.{i}`` from the top, utils.py:243); ``nin_shortcut``
    becomes ``conv_shortcut`` (utils.py:25); mid-block attention q/k/v/proj
    are stored as 1x1 convs and squeeze to linear weights (utils.py:120-129).
    """
    strip = "first_stage_model."  # full-LDM checkpoints prefix the VAE
    sd = {(k[len(strip):] if k.startswith(strip) else k): v for k, v in sd_raw.items()}
    n_up = 1 + max((int(k.split(".")[2]) for k in sd if k.startswith("decoder.up.")), default=-1)
    out: Dict[str, np.ndarray] = {}
    unmapped: List[str] = []
    for key, val in sd.items():
        if not key.startswith(("encoder.", "decoder.", "quant_conv.", "post_quant_conv.")):
            continue
        orig = key
        parts = key.split(".")
        if len(parts) > 3 and parts[1] == "down":
            rest = ".".join(parts[4:])
            if parts[3] == "block":
                key = f"encoder.down_blocks.{parts[2]}.resnets.{rest}"
            elif parts[3] == "downsample":
                key = f"encoder.down_blocks.{parts[2]}.downsamplers.0.{rest}"
            else:
                # e.g. down.{i}.attn.{j} from a non-empty attn_resolutions —
                # an architecture this VAE family does not have; dropping it
                # silently would "convert" to a numerically different model.
                unmapped.append(orig)
                continue
        elif len(parts) > 3 and parts[1] == "up":
            i = n_up - 1 - int(parts[2])
            rest = ".".join(parts[4:])
            if parts[3] == "block":
                key = f"decoder.up_blocks.{i}.resnets.{rest}"
            elif parts[3] == "upsample":
                key = f"decoder.up_blocks.{i}.upsamplers.0.{rest}"
            else:
                unmapped.append(orig)
                continue
        else:
            for old, new in _LDM_MID:
                prefix = f"{parts[0]}.{old}"
                if key.startswith(prefix):
                    key = f"{parts[0]}.{new}{key[len(prefix):]}"
                    break
            else:
                if len(parts) > 2 and parts[1] in ("mid", "attn"):
                    unmapped.append(orig)
                    continue
        key = key.replace(".nin_shortcut.", ".conv_shortcut.")
        key = key.replace(".norm_out.", ".conv_norm_out.")
        val = np.asarray(val)
        if val.ndim == 4 and any(t in key for t in (".to_q.", ".to_k.", ".to_v.", ".to_out.0.")):
            val = val[:, :, 0, 0]  # 1x1 conv -> linear
        out[key] = val
    if unmapped:
        raise ValueError(
            "LDM VAE checkpoint has layers this converter cannot map (likely a "
            f"non-empty attn_resolutions, which the reference recipe never uses — "
            f"config/ldm_autoencoder_kl.yaml:27): {sorted(unmapped)[:8]}"
        )
    return out


def vae_config_from_ldm(ddconfig: dict, scaling_factor: float = 0.18215):
    """LDM ``ddconfig`` (reference: config/ldm_autoencoder_kl.yaml:18-28) ->
    VAEConfig (the native analog of create_vae_diffusers_config,
    reference: audiodiffusion/utils.py:132-153)."""
    ch = ddconfig["ch"]
    return VAEConfig(
        in_channels=ddconfig.get("in_channels", 1),
        out_channels=ddconfig.get("out_ch", 1),
        block_out_channels=tuple(ch * m for m in ddconfig["ch_mult"]),
        layers_per_block=ddconfig.get("num_res_blocks", 2),
        latent_channels=ddconfig.get("z_channels", 1),
        sample_size=ddconfig.get("resolution", 256),
        scaling_factor=scaling_factor,
    )
