"""Port parity of the conditional tier on the CPU, continued from
test_torch_conditional.py (its tiny conditional latent pipelines and
tolerances): audio-to-audio with an encoding, and the diffusers-layout
save/load in both directions, with the Transformer2D projections as Linears
and as 1x1 convs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conditional import _cond_pipes
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_pipeline import FULL, _assert_uint8_close, _clips, _jax_draws, _state_dicts_equal

from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_tpu.models import UNet2D
from audio_diffusion_tpu.models.vae import AutoencoderKL
from audio_diffusion_tpu.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_tpu.utils.torch_export import save_pipeline_torch


@pytest.fixture(scope="module")
def cond_pipes():
    return _cond_pipes()


@pytest.mark.parametrize("mode", ["batched", "single masked"])
def test_conditional_audio_to_audio_matches_jax(cond_pipes, mode):
    jpipe, tpipe, noise, enc, _, _, _ = cond_pipes
    clips = _clips(33, 2)
    kw = dict(raw_audio=clips if mode == "batched" else clips[0, : FULL - 100], start_step=1, steps=3,
              mask_start_secs=0.1 if "masked" in mode else 0.0, return_arrays=True)
    key = jax.random.key(34)
    raw_j, _ = jpipe(noise=jnp.asarray(noise), key=key, encoding=jnp.asarray(enc), **kw)
    phase, eps, _ = _jax_draws(key, 2, (16, 16, 1), 0)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), encoding=enc, gl_phase=phase, posterior_eps=eps, **kw)
    _assert_uint8_close(raw_t.numpy(), np.asarray(raw_j))


def _shapes_only(monkeypatch):
    """The JAX import route checks converted weights against a template from
    flax's init, which only needs its shapes (as in test_torch_pipeline)."""
    for cls in (UNet2D, AutoencoderKL):
        def shapes_only(self, key, init=cls.init_params):
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: init(self, k), key))

        monkeypatch.setattr(cls, "init_params", shapes_only)


def _as_conv1x1(directory):
    """Rewrite a saved conditional UNet as diffusers writes it with
    ``use_linear_projection: false``: Transformer2D proj_in/proj_out as 1x1 convs."""
    unet_dir = directory / "unet"
    sd = torch.load(unet_dir / "diffusion_pytorch_model.bin", weights_only=True)
    n = 0
    for k in list(sd):
        if k.endswith((".proj_in.weight", ".proj_out.weight")):
            sd[k] = sd[k][:, :, None, None].clone()
            n += 1
    torch.save(sd, unet_dir / "diffusion_pytorch_model.bin")
    cfg = json.loads((unet_dir / "config.json").read_text())
    (unet_dir / "config.json").write_text(json.dumps(dict(cfg, use_linear_projection=False)))
    return n


@pytest.mark.parametrize("direction", ["jax to port", "port to jax", "port to both as 1x1 convs"])
def test_conditional_save_load_across_packages(cond_pipes, direction, tmp_path, monkeypatch):
    _shapes_only(monkeypatch)
    jpipe, tpipe, noise, enc, key, raw_j, _ = cond_pipes
    if direction == "jax to port":
        save_pipeline_torch(jpipe, str(tmp_path))
    else:
        tpipe.save_pretrained(str(tmp_path))
        index = json.loads((tmp_path / "model_index.json").read_text())
        assert index["unet"] == ["diffusers", "UNet2DConditionModel"]
        if "1x1" in direction:
            assert _as_conv1x1(tmp_path) == 2 * 4  # proj_in and proj_out: 1 down, 1 mid, 2 up Transformer2D
    if direction != "port to jax":
        loaded = TorchPipeline.from_pretrained(str(tmp_path), device="cpu")
        _state_dicts_equal(loaded.unet, tpipe.unet)
        assert loaded.unet.config == tpipe.unet.config
        raw_t, _ = loaded(noise=torch.from_numpy(noise), encoding=enc, steps=3, return_arrays=True)
        np.testing.assert_array_equal(raw_t.numpy(), raw_j)
    if direction != "jax to port":
        loaded_j = AudioDiffusionPipeline.from_pretrained(str(tmp_path))
        assert loaded_j.unet.config == jpipe.unet.config
        raw, _ = loaded_j(noise=jnp.asarray(noise), key=key, encoding=jnp.asarray(enc), steps=3, return_arrays=True)
        np.testing.assert_array_equal(np.asarray(raw), raw_j)
