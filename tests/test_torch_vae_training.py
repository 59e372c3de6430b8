"""Port parity of adversarial VAE training: the pyramid L1, DSSIM and LPIPS-
style distances, the PatchGAN discriminator, and the generator and
discriminator steps (losses and gradients) against the JAX package on the
CPU at tiny widths, with the JAX posterior draws injected. A step's
gradients are read from Adam's first moment after one update, which is
(1 - b1) * g = g / 2 at b1 = 0.5 in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import random_params
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)

from audio_diffusion_torch.models import AutoencoderKL as TorchVAE
from audio_diffusion_torch.models import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.training import perceptual as tp
from audio_diffusion_torch.training import train_vae as tv
from audio_diffusion_torch.utils import convert
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig
from audio_diffusion_tpu.training import perceptual as jp
from audio_diffusion_tpu.training import train_vae as jv

VAE_KW = dict(block_out_channels=(8, 16), layers_per_block=1, latent_channels=1, sample_size=16, norm_num_groups=4)
CFG_KW = dict(learning_rate=1e-3, disc_channels=8, disc_layers=2)


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_pyramid_l1_and_dssim_match_jax():
    a, b = _images(0, (2, 16, 16, 1)), _images(1, (2, 16, 16, 1))
    for tf, jf in ((tv.pyramid_l1, jv.pyramid_l1), (tp.dssim, jp.dssim)):
        got, want = float(tf(torch.tensor(a), torch.tensor(b))), float(jf(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= 1e-5, (tf.__name__, got, want)
    assert float(tv.pyramid_l1(torch.tensor(a), torch.tensor(a))) == 0.0


def test_perceptual_distance_matches_jax_with_converted_features():
    params = jp.init_perceptual_params(jax.random.key(7), 1)
    a, b = _images(2, (2, 32, 32, 1)), _images(3, (2, 32, 32, 1))
    want = float(jp.perceptual_distance(params, jnp.asarray(a), jnp.asarray(b)))
    ported = [[torch.from_numpy(w) for w in stage] for stage in convert.perceptual_params(params)]
    got = float(tp.perceptual_distance(ported, torch.tensor(a), torch.tensor(b)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))
    own = tp.init_perceptual_params(torch.Generator().manual_seed(7), 1)
    assert [tuple(w.shape) for s in own for w in s] == [tuple(w.shape) for s in ported for w in s]


def test_patch_discriminator_matches_jax():
    disc = jv.PatchDiscriminator(8, 3)
    x = _images(4, (2, 32, 32, 1))
    params = random_params(lambda key: disc.init(key, jnp.zeros((1, 32, 32, 1)))["params"], 5)
    want = np.asarray(disc.apply({"params": params}, jnp.asarray(x)))
    port = tv.PatchDiscriminator(8, 3)
    port.load_state_dict(convert.to_torch(convert.discriminator_state_dict(params)), strict=True)
    got = port(torch.tensor(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    cfg = VAEConfig(**VAE_KW)
    vae = AutoencoderKL(cfg)
    params = random_params(lambda key: vae.init_params(key, sample_hw=(16, 16)), 8)
    return cfg, vae, params


def _port_state(pair, jstate, tcfg):
    cfg, _, params = pair
    port = TorchVAE(TorchVAEConfig(**VAE_KW))
    port.load_state_dict(convert.to_torch(convert.vae_state_dict(params, cfg)), strict=True)
    state, disc = tv.init_vae_train_state(tcfg, port)
    disc.load_state_dict(convert.to_torch(convert.discriminator_state_dict(jstate.disc_params)), strict=True)
    return state, disc


def _eps(key, accum, micro):
    """The JAX step's posterior draws: split(key, accum), one normal per microbatch."""
    return np.stack([np.asarray(jax.random.normal(k, (micro, 8, 8, 1))) for k in jax.random.split(key, accum)])


def _assert_tree_close(got: dict, want: dict):
    """Each leaf within 1e-4 of its max abs. The attention's to_k bias has a
    zero gradient in exact arithmetic (softmax ignores a shift shared by
    every key): there both packages must give rounding noise, under 1e-6 of
    the largest gradient."""
    assert got.keys() == want.keys()
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        g = g.detach().numpy()
        if k.endswith("to_k.bias"):
            assert np.abs(g).max() <= noise and np.abs(want[k]).max() <= noise, k
        else:
            assert np.abs(g - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


@pytest.mark.parametrize("disc_start", [0, 2])
def test_generator_and_discriminator_steps_match_jax(pair, disc_start):
    """accum 2 x micro 2: losses at 1e-4 rel, gradients (2 x Adam's mu) per
    leaf within 1e-4 of its max; disc_start 2 leaves the adversarial terms
    at weight 0, and then the discriminator step's gradient is 0."""
    cfg, vae, params = pair
    jcfg = jv.VAETrainConfig(disc_start=disc_start, **CFG_KW)
    jstate, jdisc = jv.init_vae_train_state(jcfg, vae, params, (16, 16))
    jgen, jdisc_step = jv.make_vae_train_steps(jcfg, vae, jdisc)
    tcfg = tv.VAETrainConfig(disc_start=disc_start, **CFG_KW)
    state, disc = _port_state(pair, jstate, tcfg)
    gen, disc_step = tv.make_vae_train_steps(tcfg, state.vae, disc)
    images = _images(9, (2, 2, 16, 16, 1))

    key = jax.random.key(11)
    jstate, jm = jgen(jstate, jnp.asarray(images), key)
    state, m = gen(state, images, posterior_eps=_eps(key, 2, 2))
    for name in ("loss", "nll", "kl", "g_loss", "d_weight"):
        assert abs(float(m[name]) - float(jm[name])) <= 1e-4 * max(abs(float(jm[name])), 1e-6), name
    if disc_start:
        assert abs(float(m["loss"]) - float(m["nll"] + tcfg.kl_weight * m["kl"])) <= 1e-6 * abs(float(m["loss"]))
    jmu = jstate.opt_state[0].mu
    _assert_tree_close({k: 2 * v for k, v in state.opt_state.mu.items()},
                       {**convert.vae_state_dict(jax.tree_util.tree_map(lambda x: 2 * x, jmu["vae"]), cfg),
                        "logvar": 2 * np.asarray(jmu["logvar"])})

    key = jax.random.key(12)
    jstate, jdm = jdisc_step(jstate, jnp.asarray(images), key)
    before = {k: p.detach().clone() for k, p in state.disc.named_parameters()}
    state, dm = disc_step(state, images, posterior_eps=_eps(key, 2, 2))
    assert state.step == 2
    assert abs(float(dm["disc_loss"]) - float(jdm["disc_loss"])) <= 1e-4 * abs(float(jdm["disc_loss"]))
    got_mu = {k: 2 * v for k, v in state.disc_opt_state.mu.items()}
    _assert_tree_close(got_mu, convert.discriminator_state_dict(
        jax.tree_util.tree_map(lambda x: 2 * x, jstate.disc_opt_state[0].mu)))
    if disc_start:
        assert all(float(v.abs().max()) == 0.0 for v in got_mu.values())
        assert all(torch.equal(p, before[k]) for k, p in state.disc.named_parameters())


def test_vae_training_main_saves_a_vae_the_unet_trainer_reads(tmp_path):
    from audio_diffusion_torch.training.loop import load_vae

    ds = tmp_path / "slices"
    ds.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)).save(ds / f"s{i}.png")
    out = str(tmp_path / "vae")
    result = tv.main(["-d", str(ds), "-b", "2", "--max_steps", "3", "--base_channels", "8", "--ch_mult", "1,2",
                      "--norm_num_groups", "4", "--disc_start", "1", "--device", "cpu", "--hf_checkpoint_dir", out,
                      "--save_images_batches", "1000"])
    assert result["steps"] == 3
    vae = load_vae(out, "cpu")
    assert vae.config.block_out_channels == (8, 16) and vae.config.latent_hw(32, 32) == (16, 16)
    with pytest.raises(ValueError, match="perceptual_kind"):
        tv.make_vae_train_steps(tv.VAETrainConfig(perceptual_kind="vgg"), vae, tv.PatchDiscriminator(8, 2))
