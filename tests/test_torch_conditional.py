"""Port parity of the conditional tier on the CPU: the cross-attention
modules, the conditional UNet, and the conditional latent pipeline with
``encoding=`` and its guards. Audio-to-audio with an encoding and the
diffusers-layout save/load in both directions are in
test_torch_conditional_pipeline.py, on this file's pipelines.

The same seeded numpy parameters and inputs go through the flax module and
the port's (kernels through their plain versions), in f32. Tolerances:
modules 1e-5, the tiny UNet 1e-4 (the torch-twin bound); the generated
uint8 spectrograms equal, audio-to-audio ones within test_torch_pipeline's
bound (1 on at most 0.5% of the pixels: the posterior draw and the re-noise
round differently in the last f32 bit), and int16 audio within 2 LSB given
one spectrogram and Griffin-Lim phase."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import random_params
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_pipeline import VAE_KW, _jax_draws, _noise, _pair

from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import conditional_config as torch_conditional_config
from audio_diffusion_torch.models import unet2d as tu
from audio_diffusion_torch.ops.attention import dot_product_attention_plain
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.pipelines.pipeline import pcm16_quantize
from audio_diffusion_torch.utils import convert
from audio_diffusion_torch.utils.convert import to_torch, unet_state_dict
from audio_diffusion_tpu.models import UNet2D, UNetConfig, conditional_config
from audio_diffusion_tpu.models import unet2d as ju
from audio_diffusion_tpu.utils.torch_export import export_unet

# The tiny conditional UNet of tests/test_graft_entry.py:59-65, cross dim 12.
COND_KW = dict(sample_size=(16, 16), block_out_channels=(8, 16),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
               layers_per_block=1, norm_num_groups=4, attention_head_dim=4, cross_attention_dim=12)
DIM, HEADS, HEAD_DIM, CROSS = 16, 4, 4, 12


def _load(module, fill, params):
    """Convert flax ``params`` with one of ``convert``'s writers into ``module`` (strict)."""
    sd = {}
    fill(sd, "m", params)
    module.load_state_dict(to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    return module


def _tokens(rng, n, dim, offset=0.5):
    return (rng.standard_normal((2, n, dim)) + offset).astype(np.float32)


# (flax module, port module, convert writer, inputs for flax from a numpy rng)
MODULES = {
    "cross_attention self": (lambda: ju.CrossAttention(DIM, HEADS, HEAD_DIM),
                             lambda: tu.CrossAttention(DIM, HEADS, HEAD_DIM), convert._cross_attention,
                             lambda r: (_tokens(r, 5, DIM),)),
    "cross_attention context 1": (lambda: ju.CrossAttention(DIM, HEADS, HEAD_DIM),
                                  lambda: tu.CrossAttention(DIM, HEADS, HEAD_DIM, CROSS), convert._cross_attention,
                                  lambda r: (_tokens(r, 5, DIM), _tokens(r, 1, CROSS))),
    "cross_attention context 3": (lambda: ju.CrossAttention(DIM, HEADS, HEAD_DIM),
                                  lambda: tu.CrossAttention(DIM, HEADS, HEAD_DIM, CROSS), convert._cross_attention,
                                  lambda r: (_tokens(r, 5, DIM), _tokens(r, 3, CROSS))),
    "feed_forward_geglu": (lambda: ju.FeedForwardGEGLU(DIM), lambda: tu.FeedForwardGEGLU(DIM), convert._feed_forward,
                           lambda r: (_tokens(r, 5, DIM),)),
    "transformer_block": (lambda: ju.TransformerBlock(DIM, HEADS, HEAD_DIM),
                          lambda: tu.TransformerBlock(DIM, HEADS, HEAD_DIM, CROSS), convert._transformer_block,
                          lambda r: (_tokens(r, 5, DIM), _tokens(r, 3, CROSS))),
    "transformer2d": (lambda: ju.Transformer2D(HEADS, HEAD_DIM, groups=4),
                      lambda: tu.Transformer2D(DIM, HEADS, HEAD_DIM, CROSS, groups=4), convert._transformer2d,
                      lambda r: (r.standard_normal((2, 4, 6, DIM)).astype(np.float32) * 2 + 1, _tokens(r, 3, CROSS))),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_modules_match_flax(name):
    make_flax, make_port, fill, inputs = MODULES[name]
    args = inputs(np.random.default_rng(3))
    flax_mod, jargs = make_flax(), [jnp.asarray(a) for a in args]
    params = random_params(lambda k: flax_mod.init(k, *jargs)["params"], 4)
    want = np.asarray(jax.jit(flax_mod.apply)({"params": params}, *jargs))
    port = _load(make_port(), fill, params)
    targs = [torch.from_numpy(a) for a in args]
    if name == "transformer2d":  # the port's activations are NCHW
        targs[0] = targs[0].permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(*targs)
    if name == "transformer2d":
        got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_follows_jax_math(dtype):
    """f32 logits and softmax, probabilities rounded to v's dtype before P V."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, n, 4, 16)).astype(np.float32) for n in (7, 3, 3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.nn.dot_product_attention(*(jnp.asarray(a, jd) for a in (q, k, v))).astype(jnp.float32))
    got = dot_product_attention_plain(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td
    # bf16: the output rounds once to bf16 in both (one ulp, 2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 if dtype == "float32" else 2**-8 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_conditional_unet_matches_flax(fused):
    kw = dict(COND_KW, fused_groupnorm=fused)
    cfg = UNetConfig(**kw)
    params = random_params(UNet2D(cfg).init_params, 1)
    sd = unet_state_dict(params, cfg)
    theirs = export_unet(params, cfg)
    assert sorted(sd) == sorted(theirs) and all(np.array_equal(sd[k], theirs[k]) for k in sd)
    port = TorchUNet(TorchUNetConfig(**kw))
    port.load_state_dict(to_torch(sd), strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = np.array([999, 37], dtype=np.int32)
    enc = rng.standard_normal((2, 3, 12)).astype(np.float32)
    want = np.asarray(jax.jit(UNet2D(cfg).apply)({"params": params}, x, t, enc))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="requires encoder_hidden_states"):
        port(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)))


def test_conditional_config_and_guards():
    """The flagship's wiring and head-count quirk (attention_head_dim is the
    NUMBER of heads: 8 heads of dim 16, 32, 64, 64), and the 16,384-token
    guard with the JAX package's text."""
    assert dataclasses.asdict(torch_conditional_config((64, 64))) == {
        k: v for k, v in dataclasses.asdict(conditional_config((64, 64))).items()
        if k in {f.name for f in dataclasses.fields(TorchUNetConfig)}}
    cfg = torch_conditional_config((64, 64), cross_attention_dim=100)
    with torch.device("meta"):
        unet = TorchUNet(cfg)
    heads = [(m.attn1.heads, m.attn1.head_dim) for m in unet.modules() if isinstance(m, tu.TransformerBlock)]
    assert len(heads) == 16 and set(heads) == {(8, 16), (8, 32), (8, 64)}
    assert unet.mid_block.attentions[0].transformer_blocks[0].attn2.to_k.in_features == 100
    with torch.device("meta"):
        wide = TorchUNet(TorchUNetConfig(**dict(COND_KW, sample_size=(256, 256))))
    with pytest.raises(ValueError, match=r"at level 0 would attend over 65536 tokens .* infeasible"):
        wide(torch.zeros(1, 256, 256, 1), torch.zeros(1), torch.zeros(1, 1, 12))


# ------------------------------------------------------------------- pipeline

def _cond_pipes():
    """The tiny conditional latent pipeline in both packages, and the JAX
    package's answer to one encoded request."""
    jpipe, tpipe = _pair(COND_KW, VAE_KW)
    noise = _noise(30)
    enc = np.random.default_rng(31).standard_normal((2, 1, 12)).astype(np.float32)
    key = jax.random.key(32)
    raw_j, audio_j = jpipe(noise=jnp.asarray(noise), key=key, encoding=jnp.asarray(enc), steps=3,
                           return_arrays=True, pcm16=True)
    return jpipe, tpipe, noise, enc, key, np.asarray(raw_j), np.asarray(audio_j)


@pytest.fixture(scope="module")
def cond_pipes():
    return _cond_pipes()


def test_conditional_pipeline_matches_jax(cond_pipes):
    jpipe, tpipe, noise, enc, key, raw_j, audio_j = cond_pipes
    phase, _, _ = _jax_draws(key, 2, (16, 16, 1), 0)
    raw_t, audio_t = tpipe(noise=torch.from_numpy(noise), encoding=enc, steps=3, gl_phase=phase,
                           return_arrays=True, pcm16=True)
    np.testing.assert_array_equal(raw_t.numpy(), raw_j)
    assert audio_t.shape == audio_j.shape and audio_t.dtype == torch.int16
    audio_from_j = pcm16_quantize(tpipe.mel.images_to_audio(torch.from_numpy(raw_j.copy()), phase=phase)).numpy()
    assert np.abs(audio_from_j.astype(np.int32) - audio_j.astype(np.int32)).max() <= 2
    np.testing.assert_array_equal(audio_t.numpy(), audio_from_j)


def test_conditional_pipeline_encoding_guards(cond_pipes):
    """The guards of tests/test_pipeline.py:187-222 on the port: a 2-D (B, dim)
    encoding is the 3-D (B, 1, dim) one; other encodings give other images;
    a wrong dim, a wrong batch (the noise's, when noise= is given) and an
    unconditional UNet raise; a conditional UNet without one raises too."""
    _, tpipe, noise, enc, _, _, _ = cond_pipes
    kw = dict(noise=torch.from_numpy(noise), steps=2, return_images_only=True)
    three = tpipe(encoding=enc, **kw)
    np.testing.assert_array_equal(tpipe(encoding=enc[:, 0], **kw), three)
    assert not np.array_equal(tpipe(encoding=enc[::-1].copy(), **kw)[0], three[0])
    with pytest.raises(ValueError, match="cross_attention_dim"):
        tpipe(batch_size=1, steps=2, encoding=np.ones((1, 7)))
    with pytest.raises(ValueError, match="batch axis"):
        tpipe(batch_size=2, steps=2, encoding=np.ones((1, 1, 12)))
    noise4 = torch.randn(4, 16, 16, 1, generator=torch.Generator().manual_seed(3))
    assert tpipe(steps=2, noise=noise4, encoding=np.ones((4, 1, 12)), return_images_only=True).shape[0] == 4
    with pytest.raises(ValueError, match="batch"):
        tpipe(steps=2, noise=noise4, encoding=np.ones((2, 1, 12)))
    with pytest.raises(ValueError, match="requires encoder_hidden_states"):
        tpipe(batch_size=1, steps=2)
    with pytest.raises(ValueError, match="requires encoder_hidden_states"):  # DDIM inversion is unconditional
        tpipe.encode(tpipe(encoding=enc, noise=torch.from_numpy(noise), steps=2).images, steps=2)
    uncond = TorchPipeline(TorchUNet(TorchUNetConfig(**dict(COND_KW, cross_attention_dim=None,
                                                            down_block_types=("DownBlock2D",) * 2,
                                                            up_block_types=("UpBlock2D",) * 2))),
                           tpipe.mel, tpipe.scheduler, device="cpu")
    with pytest.raises(ValueError, match="unconditional"):
        uncond(batch_size=1, steps=2, encoding=np.ones((1, 1, 12)))
