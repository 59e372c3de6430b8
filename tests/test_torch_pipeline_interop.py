"""Port parity of the pipeline, continued from test_torch_pipeline.py (the
same tiny pipelines and tolerances, built by its helpers): DDIM inversion
and slerp, the diffusers-layout save/load in both directions, the output
forms and refused options, and sharded inference bitwise the unsharded call."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_pipeline import (MEL_KW, UNET_KW, VAE_KW, _assert_uint8_close, _clips, _jax_draws, _noise, _pair,
                                 _state_dicts_equal)

from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_tpu.models import UNet2D
from audio_diffusion_tpu.models.vae import AutoencoderKL
from audio_diffusion_tpu.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_tpu.utils.torch_export import save_pipeline_torch


@pytest.fixture(scope="module")
def pipes():
    return _pair(UNET_KW, VAE_KW)


@pytest.fixture(scope="module")
def pixel_pipes():
    return _pair(dict(UNET_KW, sample_size=(32, 32)))


def test_encode_and_slerp_match_jax(pipes):
    """DDIM inversion over the VAE posterior mode, fed back through noise=."""
    jpipe, tpipe = pipes
    images = jpipe(noise=jnp.asarray(_noise(19)), steps=3, key=jax.random.key(20)).images
    enc_j = np.asarray(jpipe.encode(images, steps=3))
    enc_t = tpipe.encode(images, steps=3).numpy()
    assert enc_t.shape == enc_j.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(enc_t, enc_j, atol=1e-4 * np.abs(enc_j).max())

    mixed_j = np.asarray(AudioDiffusionPipeline.slerp(enc_j[:1], enc_j[1:], 0.3))
    mixed_t = TorchPipeline.slerp(torch.from_numpy(enc_j[:1]), torch.from_numpy(enc_j[1:]), 0.3).numpy()
    np.testing.assert_allclose(mixed_t, mixed_j, atol=1e-6)

    noise = np.concatenate([enc_j, mixed_j])
    raw_j, _ = jpipe(noise=jnp.asarray(noise), steps=3, return_arrays=True)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, return_arrays=True)
    _assert_uint8_close(raw_t.numpy(), raw_j)


@pytest.mark.parametrize("kind", ["latent", "pixel"])
def test_diffusers_layout_loads_across_packages(pipes, pixel_pipes, kind, tmp_path, monkeypatch):
    """JAX ``save_pipeline_torch`` -> port ``from_pretrained``, and port
    ``save_pretrained`` -> JAX ``from_pretrained`` (its torch-import route):
    each loaded pipeline gives the other package's spectrograms."""
    # The JAX import route checks the converted weights against a template
    # from flax's init, which only needs its shapes; flax's own init runs op
    # by op on the CPU (~30 s for the VAE), so the template is made from
    # jax.eval_shape instead.
    for cls in (UNet2D, AutoencoderKL):
        def shapes_only(self, key, init=cls.init_params):
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: init(self, k), key))

        monkeypatch.setattr(cls, "init_params", shapes_only)
    jpipe, tpipe = pipes if kind == "latent" else pixel_pipes
    h, w = tpipe.sample_hw
    noise = _noise(21, (2, h, w, 1))
    raw_j, _ = jpipe(noise=jnp.asarray(noise), steps=3, return_arrays=True)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, return_arrays=True)

    save_pipeline_torch(jpipe, str(tmp_path / "from_jax"))
    loaded_t = TorchPipeline.from_pretrained(str(tmp_path / "from_jax"), fused_groupnorm=True, device="cpu")
    _state_dicts_equal(loaded_t.unet, tpipe.unet)
    assert loaded_t.unet.config == tpipe.unet.config and loaded_t.mel.config == tpipe.mel.config
    assert (loaded_t.vqvae is None) == (kind == "pixel")
    _assert_uint8_close(loaded_t(noise=torch.from_numpy(noise), steps=3, return_arrays=True)[0].numpy(), raw_j)

    tpipe.save_pretrained(str(tmp_path / "from_torch"))
    with open(tmp_path / "from_torch" / "model_index.json") as fh:
        assert json.load(fh)["_class_name"] == "AudioDiffusionPipeline"
    loaded_j = AudioDiffusionPipeline.from_pretrained(str(tmp_path / "from_torch"))
    assert dataclasses.replace(loaded_j.unet.config, fused_groupnorm=True) == jpipe.unet.config
    _assert_uint8_close(raw_t.numpy(), np.asarray(loaded_j(noise=jnp.asarray(noise), steps=3,
                                                           return_arrays=True)[0]))
    overridden = TorchPipeline.from_pretrained(str(tmp_path / "from_torch"), dtype="bfloat16", device="cpu")
    assert overridden.unet.config.dtype == "bfloat16" and not overridden.unet.config.fused_groupnorm
    if kind == "latent":
        assert overridden.vqvae.config.dtype == "bfloat16"
        _state_dicts_equal(overridden.vqvae, tpipe.vqvae)


def test_pipeline_output_and_unported_options(pipes, tmp_path):
    _, tpipe = pipes
    out = tpipe(batch_size=1, steps=2, generator=torch.Generator().manual_seed(0))
    assert out.raw_images.shape == (1, 32, 32) and out.images[0].size == (32, 32)
    assert out.audios[0].shape == (31 * 512,) and np.isfinite(out.audios[0]).all()
    images, (sr, audios) = tpipe(batch_size=1, steps=2, return_dict=False)
    assert sr == 22050 and len(images) == len(audios) == 1
    raw = tpipe(batch_size=1, steps=2, return_images_only=True)
    np.testing.assert_array_equal(raw, out.raw_images)  # the same seed-0 generator draws the same noise
    nchw = tpipe(noise=torch.from_numpy(_noise(22)).permute(0, 3, 1, 2), steps=2, return_images_only=True)
    np.testing.assert_array_equal(nchw, tpipe(noise=torch.from_numpy(_noise(22)), steps=2, return_images_only=True))
    with pytest.raises(ValueError, match="unconditional"):
        tpipe(batch_size=1, steps=2, encoding=np.zeros((1, 4)))
    with pytest.raises(ValueError, match="start_step .* must be < steps"):
        tpipe(batch_size=1, start_step=500, steps=3)
    with pytest.raises(ValueError, match="raw_audio batch"):
        tpipe(raw_audio=_clips(0, 3), noise=torch.from_numpy(_noise(0)), steps=2)
    with pytest.raises(ValueError, match="per-row step_generator"):
        tpipe(batch_size=2, steps=2, eta=1.0, step_generator=[torch.Generator()])
    with pytest.raises(FileNotFoundError, match="Hub model id"):
        TorchPipeline.from_pretrained("teticio/audio-diffusion-256", device="cpu")
    tpipe.save_pretrained(str(tmp_path))
    unet_dir = tmp_path / "unet"
    os.replace(unet_dir / "diffusion_pytorch_model.bin", unet_dir / "diffusion_pytorch_model.safetensors")
    with pytest.raises(ValueError, match="safetensors"):
        TorchPipeline.from_pretrained(str(tmp_path), device="cpu")


# ---------------------------------------------------- sharded inference (tests/test_pipeline.py:241-261, 310-336)

@pytest.fixture
def one_thread():
    """torch's CPU kernels give a row the same bits in any batch only on one
    thread (GroupNorm splits a group's reduction across threads when batch x
    groups is small) and with at least 2 rows (a lone row takes GEMV and
    another convolution kernel): the sharded tests run so, 2 rows per replica."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sharded(tpipe, n=2):
    """``tpipe``'s modules split over ``n`` shares of the CPU (``make_mesh`` allows a repeated device)."""
    from audio_diffusion_torch.parallel import make_mesh

    return TorchPipeline(tpipe.unet, TorchMel(**MEL_KW, device="cpu"), tpipe.scheduler, tpipe.vqvae,
                         device="cpu").shard(make_mesh(devices=["cpu"] * n))


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_sharded_generation_matches_unsharded_and_jax(pipes, one_thread):
    """The sharded call is bitwise the unsharded one, with injected draws and
    with the draws of a generator (made on the primary device in the
    unsharded order), and within the port's tolerance of the JAX package's."""
    jpipe, tpipe = pipes
    sharded = _sharded(tpipe)
    noise = _noise(12, (4, 16, 16, 1))
    key = jax.random.key(13)
    raw_j, _ = jpipe(batch_size=4, steps=3, key=key, noise=jnp.asarray(noise), return_arrays=True, pcm16=True)
    phase, _, _ = _jax_draws(key, 4, (16, 16, 1), 0)
    kw = dict(noise=torch.from_numpy(noise), steps=3, gl_phase=phase, return_arrays=True, pcm16=True)
    got = sharded(**kw)
    _assert_equal(got, tpipe(**kw))
    _assert_uint8_close(got[0].numpy(), np.asarray(raw_j))
    for extra in ({}, {"eta": 0.7}):  # noise, then step noise of the shared chain, then the phase
        kw = dict(batch_size=4, steps=2, return_arrays=True, **extra)
        _assert_equal(sharded(generator=torch.Generator().manual_seed(3), **kw),
                      tpipe(generator=torch.Generator().manual_seed(3), **kw))
    out = sharded(batch_size=4, steps=2)
    assert len(out.audios) == 4 and out.raw_images.shape == (4, 32, 32)
    np.testing.assert_array_equal(sharded(batch_size=4, steps=2, return_images_only=True), out.raw_images)
    with pytest.raises(ValueError, match="multiple of the mesh's data-axis size"):
        sharded(batch_size=3, steps=2)


def test_sharded_audio_to_audio_matches_unsharded(pipes, one_thread):
    """Batched rows split with their clips; one broadcast clip takes its
    posterior draw from the generator on the primary device, as the
    unsharded call does."""
    _, tpipe = pipes
    sharded = _sharded(tpipe)
    batched = dict(raw_audio=_clips(14, 4), noise=torch.from_numpy(_noise(15, (4, 16, 16, 1))), start_step=1,
                   steps=3, mask_start_secs=0.1, return_arrays=True)
    single = dict(raw_audio=_clips(16, 1)[0], batch_size=4, start_step=1, steps=3, mask_end_secs=0.1,
                  return_arrays=True)
    for kw in (batched, single):
        _assert_equal(sharded(generator=torch.Generator().manual_seed(4), **kw),
                      tpipe(generator=torch.Generator().manual_seed(4), **kw))
    with pytest.raises(ValueError, match="raw_audio batch"):
        sharded(raw_audio=_clips(0, 2), noise=torch.from_numpy(_noise(0, (4, 16, 16, 1))), steps=2)


def test_sharded_conditional_and_per_row_generators(one_thread):
    """encoding= rows and per-row step generators split with their rows (DDPM: every step draws)."""
    kw = dict(UNET_KW, sample_size=(32, 32), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
              up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4, cross_attention_dim=12)
    unet = TorchUNet(TorchUNetConfig(**kw)).init_params(torch.Generator().manual_seed(5))
    tpipe = TorchPipeline(unet, TorchMel(**MEL_KW, device="cpu"),
                          TorchDDPM(TorchSchedulerConfig(num_train_timesteps=100)), device="cpu")
    sharded = _sharded(tpipe)
    enc = np.random.default_rng(6).standard_normal((4, 1, 12)).astype(np.float32)
    for gens in (None, lambda: [torch.Generator().manual_seed(s) for s in range(4)]):
        call = dict(batch_size=4, steps=3, encoding=enc, return_arrays=True)
        a = tpipe(generator=torch.Generator().manual_seed(7), step_generator=gens and gens(), **call)
        b = sharded(generator=torch.Generator().manual_seed(7), step_generator=gens and gens(), **call)
        _assert_equal(a, b)
    with pytest.raises(ValueError, match="encoding batch axis"):
        sharded(batch_size=2, steps=2, encoding=enc)
    from audio_diffusion_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="along 'data' only"):
        tpipe.shard(make_mesh(num_data=1, num_model=2, devices=["cpu", "cpu"]))
