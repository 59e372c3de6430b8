"""AudioEncoder: audio -> 100-d conditioning embedding
(port of ``audio_diffusion_tpu/models/audio_encoder.py``).

The reference's CNN audio embedder (audiodiffusion/audio_encoder.py:7-107):
3x [SeparableConv2d 3x3 -> LeakyReLU(0.2) -> BatchNorm(eps=1e-3) -> MaxPool
2x2 -> Dropout], channels 1->32->64->128, then flatten -> Dense 41472->1024
-> LeakyReLU -> BatchNorm -> Dropout(0.5) -> Dense 1024->100.

``forward(x, train=False)`` is the JAX module's ``__call__(x, train)``, and
the argument alone decides the mode (``.train()``/``.eval()`` do not):
``train=False`` reads BatchNorm's running statistics and drops nothing;
``train=True`` normalizes with the batch's statistics and updates the
running ones as flax does (biased variance E[x^2] - E[x]^2, ``ra = 0.99 ra +
0.01 batch``, eps 1e-3), and dropout draws its masks from ``generator``
(inverted dropout: kept values scaled by 1 / (1 - rate)). ``encode`` always
runs ``train=False``.

Activations are NCHW, as in the reference's torch module, which permutes to
NHWC before the flatten (audio_encoder.py:54); so does this one, or the
41,472 -> 1,024 dense layer would see its features in another order. The
parameter and buffer names are the reference's, the layout that
``audio_diffusion_tpu/utils/torch_import.py::convert_audio_encoder`` reads.

Its Mel is 216 x 96 (x_res x y_res), and slices are scaled by /255, not to
[-1, 1], before the forward (audio_encoder.py:95). All slices of all files
go through one forward.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..mel import Mel
from ..utils import diffusers_io
from ..utils.config import ConfigMixin
from .unet2d import init_flax_defaults


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig(ConfigMixin):
    """The JAX package's ``AudioEncoderConfig``; the dropout rates act under ``train=True`` only."""

    channels: tuple = (32, 64, 128)
    dropout_rates: tuple = (0.2, 0.3, 0.4)
    dense_features: int = 1024
    dense_dropout: float = 0.5
    embedding_dim: int = 100
    mel_x_res: int = 216
    mel_y_res: int = 96

    config_name = "config.json"


FLAX_MOMENTUM = 0.99  # flax's BatchNorm momentum; torch calls the complement, 0.01, its momentum


def _batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm, train: bool) -> torch.Tensor:
    """flax ``BatchNorm`` over every axis but 1: the running statistics, or
    with ``train`` the batch's (updating the running ones in place)."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
    dims = [d for d in range(x.dim()) if d != 1]
    mean = x.mean(dims)
    var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)  # flax's use_fast_variance, biased
    with torch.no_grad():
        bn.running_mean.copy_(FLAX_MOMENTUM * bn.running_mean + (1.0 - FLAX_MOMENTUM) * mean)
        bn.running_var.copy_(FLAX_MOMENTUM * bn.running_var + (1.0 - FLAX_MOMENTUM) * var)
        bn.num_batches_tracked += 1
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def _dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: the identity unless ``train``; else each value kept
    with probability 1 - rate and scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class SeparableConv2d(nn.Module):
    """Depthwise 3x3 (groups = channels, no bias), then pointwise 1x1."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.depthwise = nn.Conv2d(in_channels, in_channels, 3, padding=1, groups=in_channels, bias=False)
        self.pointwise = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0):
        super().__init__()
        self.sep_conv = SeparableConv2d(in_channels, out_channels)
        self.batch_norm = nn.BatchNorm2d(out_channels, eps=1e-3, momentum=0.01)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        x = _batch_norm(F.leaky_relu(self.sep_conv(x), 0.2), self.batch_norm, train)
        return _dropout(F.max_pool2d(x, 2), self.dropout, train, generator)


class DenseBlock(nn.Module):
    def __init__(self, in_features: int, out_features: int, dropout: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features)
        self.batch_norm = nn.BatchNorm1d(out_features, eps=1e-3, momentum=0.01)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC flatten: the reference's feature order
        x = _batch_norm(F.leaky_relu(self.dense(x), 0.2), self.batch_norm, train)
        return _dropout(x, self.dropout, train, generator)


class AudioEncoder(nn.Module):
    """Built on the CPU with torch's default init; move it with ``.to(device)``."""

    def __init__(self, config: AudioEncoderConfig = AudioEncoderConfig()):
        super().__init__()
        self.config = cfg = config
        chans = (1,) + tuple(cfg.channels)
        self.conv_blocks = nn.ModuleList([ConvBlock(chans[i], chans[i + 1], cfg.dropout_rates[i])
                                          for i in range(len(cfg.channels))])
        n = len(cfg.channels)
        flat = (cfg.mel_y_res >> n) * (cfg.mel_x_res >> n) * cfg.channels[-1]  # 12 * 27 * 128 = 41,472
        self.dense_block = DenseBlock(flat, cfg.dense_features, cfg.dense_dropout)
        self.embedding = nn.Linear(cfg.dense_features, cfg.embedding_dim)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        """x: (B, 1, y_res, x_res) mel images scaled to [0, 1] (/255) -> (B,
        embedding_dim). ``train``: batch statistics (updated in place) and
        dropout drawn from ``generator`` (module docstring)."""
        for block in self.conv_blocks:
            x = block(x, train, generator)
        return self.embedding(self.dense_block(x, train, generator))

    def init_params(self, generator: torch.Generator) -> "AudioEncoder":
        """Seeded random init with flax's defaults (:func:`.unet2d.init_flax_defaults`);
        BatchNorm scale one, bias zero, running mean zero and variance one."""
        init_flax_defaults(self, generator)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
        return self

    # ------------------------------------------------------------- inference
    def make_mel(self) -> Mel:
        """The encoder's 216 x 96 Mel, on the encoder's device."""
        return Mel(x_res=self.config.mel_x_res, y_res=self.config.mel_y_res, device=self.embedding.weight.device)

    @torch.inference_mode()
    def encode(self, audio_files: Sequence[Union[str, np.ndarray]], pool: Optional[str] = "average",
               mel: Optional[Mel] = None):
        """Embed audio files (paths or raw arrays at the Mel's rate) -> (n_files,
        embedding_dim), or with ``pool=None`` a list of (n_slices, embedding_dim)
        (reference: audio_encoder.py:84-107). Every slice of every file goes
        through one forward."""
        if pool not in ("average", "max", None):
            raise ValueError(f"Unknown pooling method {pool}")
        mel = mel or self.make_mel()
        slices, counts = [], []
        for f in audio_files:
            if isinstance(f, str):
                mel.load_audio(audio_file=f)
            else:
                mel.load_audio(raw_audio=f)
            n = mel.get_number_of_slices()
            slices.append(mel.spectrogram_images_from_audio(np.stack([mel.get_audio_slice(i) for i in range(n)])))
            counts.append(n)
        images = torch.cat(slices).to(self.embedding.weight.device, torch.float32) / 255.0
        embeddings = self(images[:, None], train=False)
        out = list(torch.split(embeddings, counts))
        if pool == "average":
            return torch.stack([e.mean(0) for e in out])
        if pool == "max":
            return torch.stack([e.amax(0) for e in out])
        return out

    # ----------------------------------------------------------- persistence
    def save_pretrained(self, directory: str) -> None:
        """``config.json`` and ``diffusion_pytorch_model.bin`` with the
        reference's keys: what ``torch_import.load_audio_encoder`` reads."""
        config = {**self.config.config_dict(), "_class_name": "AudioEncoder",
                  "_diffusers_version": diffusers_io.DIFFUSERS_VERSION}
        config.pop("_version")
        diffusers_io.write_json(config, os.path.join(directory, self.config.config_name))
        diffusers_io.save_state_dict(self, directory)

    @classmethod
    def from_pretrained(cls, directory: str, device: torch.device | str = "cuda") -> "AudioEncoder":
        """Load what :meth:`save_pretrained` (or the reference's
        ``AudioEncoder.save_pretrained``) writes, on ``device``."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AudioEncoder: CUDA device requested but torch.cuda is not available")
        encoder = cls(AudioEncoderConfig.from_pretrained(directory))
        encoder.load_state_dict(diffusers_io.load_state_dict(directory), strict=True)
        return encoder.to(device).eval()
