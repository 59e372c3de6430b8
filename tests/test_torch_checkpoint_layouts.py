"""The JAX package's native checkpoint layout and ``.safetensors`` in the port.

- ``utils/flax_msgpack.py`` against flax: the port reads what
  ``flax.serialization.to_bytes`` writes leaf for leaf and bitwise (a tiny
  UNet's tree, scalars, an array forced through the chunked form) and writes
  the same bytes, which flax reads back.
- ``utils/safetensors_io.py`` against the ``safetensors`` package, both ways.
- ``utils/convert.py``'s inverse against ``torch_import.convert_unet`` /
  ``convert_vae``, and the round trip, bitwise; its structure check.
- Pipelines across packages: a directory the JAX package's
  ``save_pretrained`` writes loads into the port's ``from_pretrained``, and a
  native directory the port writes loads into the JAX package's, each giving
  the other package's spectrograms within the port's uint8 tolerance (at most
  1 apart on at most 0.5% of pixels), with the noise injected.
- ``convert_checkpoint --to native`` / ``--to torch`` round trips; empty and
  truncated ``params.msgpack`` files raise the named ``ValueError``.
- A JAX ``remat=True`` pipeline keeps ``remat`` through the port's
  ``from_pretrained``, ``save_pretrained`` in both layouts and
  ``convert_checkpoint --to native``.

``msgpack``, ``flax`` and ``safetensors`` are used here only to write the
reference files; the port imports none of them."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import COND_KW, random_params
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)
from test_torch_pipeline import UNET_KW, VAE_KW, _assert_uint8_close, _noise, _pair, _state_dicts_equal

from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.models.audio_encoder import AudioEncoder as TorchAudioEncoder
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.scripts import convert_checkpoint
from audio_diffusion_torch.utils import convert, diffusers_io, flax_msgpack, safetensors_io
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig
from audio_diffusion_tpu.pipelines.pipeline import AudioDiffusionPipeline
from audio_diffusion_tpu.utils import torch_import


def _flax():
    return pytest.importorskip("flax.serialization")


def _leaves_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(str(k) for k in want), path
        for k in want:
            _leaves_equal(got[str(k)], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert np.asarray(got).dtype == want.dtype and np.asarray(got).shape == want.shape, path
        assert np.asarray(got).tobytes() == want.tobytes(), path
    else:
        assert got == want and type(got) is type(want), path


def _f32_params(init_fn, seed):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), random_params(init_fn, seed))


def _unet_tree():
    """A tiny UNet's flax parameter tree plus the scalar leaves a tree may hold."""
    tree = _f32_params(UNet2D(UNetConfig(**UNET_KW)).init_params, 1)
    tree["extra"] = {"step": np.int64(7), "scale": np.float32(0.5), "count": 300, "neg": -70000, "rate": 1e-4,
                     "name": "unet" * 9, "flag": True, "none": None, "half": np.arange(6, dtype=np.float16)}
    return tree


@pytest.mark.parametrize("chunked", [False, True])
def test_port_reads_and_writes_flax_bytes(chunked, monkeypatch):
    """flax's bytes -> the port's ``from_bytes`` leaf for leaf; the port's
    ``to_bytes`` gives flax's bytes, and flax reads them back. ``chunked``
    lowers both packages' MAX_CHUNK_SIZE so the larger kernels take the
    chunked-array form."""
    serialization = _flax()
    tree = _unet_tree()
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    data = serialization.to_bytes(tree)
    if chunked:
        raw = serialization.msgpack.unpackb(data, raw=False)
        assert raw["conv_in"]["kernel"].__class__ is not dict  # 288 floats: whole
        assert raw["mid_attn"]["to_q"]["kernel"][flax_msgpack.CHUNKED] is True  # 64 x 64 floats: 4 chunks
    _leaves_equal(flax_msgpack.from_bytes(data), tree)
    ours = flax_msgpack.to_bytes(tree)
    assert ours == data
    _leaves_equal(serialization.msgpack_restore(ours), tree)
    back = serialization.from_bytes(jax.tree.map(np.zeros_like, tree), ours)
    _leaves_equal(back, tree)


def test_empty_and_truncated_params_raise(tmp_path):
    """A native directory whose params.msgpack is empty or cut short raises
    ValueError naming the file, as the JAX package's ``_read_params`` does."""
    _, tpipe = _pair(UNET_KW)
    tpipe.save_pretrained(str(tmp_path / "p"), layout="native")
    path = tmp_path / "p" / "unet" / "params.msgpack"
    data = path.read_bytes()
    for bad, what in ((b"", "is empty"), (data[: len(data) // 2], "corrupt or truncated")):
        path.write_bytes(bad)
        with pytest.raises(ValueError, match=what) as e:
            TorchPipeline.from_pretrained(str(tmp_path / "p"), device="cpu")
        assert str(path) in str(e.value)


def test_safetensors_read_and_written_bitwise(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(3)
    tensors = {"w": rng.standard_normal((3, 5)).astype(np.float32), "h": rng.standard_normal(7).astype(np.float16),
               "n": np.arange(4, dtype=np.int64), "s": np.array(2.0, np.float32)}
    st.save_file(tensors, str(tmp_path / "a.safetensors"))
    got = safetensors_io.load_file(str(tmp_path / "a.safetensors"))
    safetensors_io.save_file(tensors, str(tmp_path / "b.safetensors"), {"format": "pt"})
    back = st.load_file(str(tmp_path / "b.safetensors"))
    for k, v in tensors.items():
        for other in (got[k], back[k]):
            assert other.dtype == v.dtype and other.shape == v.shape and other.tobytes() == v.tobytes(), k
    bf16 = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16()
    pytest.importorskip("safetensors.torch").save_file({"b": bf16}, str(tmp_path / "c.safetensors"))
    got = safetensors_io.load_file(str(tmp_path / "c.safetensors"))["b"]
    assert got.dtype == np.float32 and torch.equal(torch.from_numpy(got), bf16.float())


@pytest.mark.parametrize("kw", [UNET_KW, COND_KW], ids=["unconditional", "conditional"])
def test_inverse_conversion_matches_torch_import_and_round_trips(kw):
    cfg = UNetConfig(**kw)
    params = _f32_params(UNet2D(cfg).init_params, 2)
    sd = convert.unet_state_dict(params, cfg)
    tcfg = TorchUNetConfig(**kw)
    ours = convert.unet_params_from_state_dict(sd, tcfg)
    _leaves_equal(ours, jax.tree.map(lambda a: np.asarray(a, np.float32), torch_import.convert_unet(sd, cfg)))
    _leaves_equal(ours, params)
    again = convert.unet_state_dict(ours, tcfg)
    assert list(again) == list(sd) and all(again[k].tobytes() == sd[k].tobytes() for k in sd)
    # from the port's module itself, as save_pretrained(layout="native") converts it
    unet = TorchUNet(tcfg)
    unet.load_state_dict(convert.to_torch(sd), strict=True)
    _leaves_equal(convert.unet_params_from_state_dict(unet.state_dict(), tcfg), params)

    vcfg = VAEConfig(**VAE_KW)
    vparams = _f32_params(AutoencoderKL(vcfg).init_params, 3)
    vsd = convert.vae_state_dict(vparams, vcfg)
    vours = convert.vae_params_from_state_dict(vsd, TorchVAEConfig(**VAE_KW))
    _leaves_equal(vours, jax.tree.map(lambda a: np.asarray(a, np.float32), torch_import.convert_vae(vsd, vcfg)))
    _leaves_equal(vours, vparams)


def test_inverse_conversion_checks_keys_and_shapes():
    cfg = TorchUNetConfig(**UNET_KW)
    sd = {k: v.numpy() for k, v in TorchUNet(cfg).state_dict().items()}
    with pytest.raises(ValueError, match="does not have"):
        convert.unet_params_from_state_dict({**sd, "mid_block.stray.weight": np.zeros(3, np.float32)}, cfg)
    with pytest.raises(ValueError, match="shape mismatch at conv_in.bias"):
        convert.unet_params_from_state_dict({**sd, "conv_in.bias": np.zeros(5, np.float32)}, cfg)
    with pytest.raises(KeyError, match="conv_out.weight"):
        convert.unet_params_from_state_dict({k: v for k, v in sd.items() if k != "conv_out.weight"}, cfg)
    # the old diffusers attention names are read as aliases
    old = {k.replace("attentions.0.to_q.", "attentions.0.query."): v for k, v in sd.items()}
    convert.unet_params_from_state_dict(old, cfg)


@pytest.fixture
def fast_flax_templates(monkeypatch):
    """The JAX ``from_pretrained`` reads params.msgpack into a template from
    flax's init, which only needs its shapes; flax's own init runs op by op on
    the CPU (~30 s for the VAE), so the template comes from jax.eval_shape."""
    for cls in (UNet2D, AutoencoderKL):
        def shapes_only(self, key, init=cls.init_params, **kw):
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                jax.eval_shape(lambda k: init(self, k, **kw), key))

        monkeypatch.setattr(cls, "init_params", shapes_only)


@pytest.mark.parametrize("kind", ["latent", "pixel"])
def test_native_layout_loads_across_packages(kind, tmp_path, fast_flax_templates):
    """Port ``save_pretrained(layout="native")`` -> JAX ``from_pretrained``,
    and JAX ``save_pretrained`` -> port ``from_pretrained``: the weights
    arrive bitwise and each loaded pipeline gives the other package's
    spectrograms. The native config carries ``fused_groupnorm``, so the port
    needs no override. (One JAX generation: flax compiles it per pipeline.)"""
    jpipe, tpipe = _pair(UNET_KW, VAE_KW) if kind == "latent" else _pair(dict(UNET_KW, sample_size=(32, 32)))
    h, w = tpipe.sample_hw
    noise = _noise(41, (2, h, w, 1))

    tpipe.save_pretrained(str(tmp_path / "from_torch"), layout="native")
    with open(tmp_path / "from_torch" / "model_index.json") as fh:
        assert json.load(fh) == {"_class_name": "AudioDiffusionPipeline", "unet": True, "scheduler": "DDIMScheduler",
                                 "mel": True, "vqvae": kind == "latent"}
    loaded_j = AudioDiffusionPipeline.from_pretrained(str(tmp_path / "from_torch"))
    assert loaded_j.unet.config == jpipe.unet.config
    _leaves_equal(jax.tree.map(np.asarray, loaded_j.unet_params), jax.tree.map(np.asarray, jpipe.unet_params))
    if kind == "latent":
        _leaves_equal(jax.tree.map(np.asarray, loaded_j.vqvae_params), jax.tree.map(np.asarray, jpipe.vqvae_params))
    raw_j = np.asarray(loaded_j(noise=jnp.asarray(noise), steps=3, return_arrays=True)[0])
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=3, return_arrays=True)
    _assert_uint8_close(raw_t.numpy(), raw_j)

    jpipe.save_pretrained(str(tmp_path / "from_jax"))
    assert (tmp_path / "from_jax" / "unet" / "params.msgpack").exists()
    loaded_t = TorchPipeline.from_pretrained(str(tmp_path / "from_jax"), device="cpu")
    assert loaded_t.unet.config == tpipe.unet.config and loaded_t.mel.config == tpipe.mel.config
    _state_dicts_equal(loaded_t.unet, tpipe.unet)
    assert (loaded_t.vqvae is None) == (kind == "pixel")
    if kind == "latent":
        _state_dicts_equal(loaded_t.vqvae, tpipe.vqvae)
    _assert_uint8_close(loaded_t(noise=torch.from_numpy(noise), steps=3, return_arrays=True)[0].numpy(), raw_j)
    overridden = TorchPipeline.from_pretrained(str(tmp_path / "from_jax"), dtype="bfloat16",
                                               fused_groupnorm=False, device="cpu")
    assert overridden.unet.config.dtype == "bfloat16" and not overridden.unet.config.fused_groupnorm


def test_safetensors_pipeline_and_audio_encoder_load_bitwise(tmp_path):
    """A diffusers directory whose weights are ``.safetensors`` (written by the
    ``safetensors`` package) loads bitwise, for the pipeline's UNet and VAE and
    for the AudioEncoder's directory."""
    st = pytest.importorskip("safetensors.numpy")
    _, tpipe = _pair(UNET_KW, VAE_KW)
    tpipe.save_pretrained(str(tmp_path / "p"))
    for sub in ("unet", "vqvae"):
        d = tmp_path / "p" / sub
        sd = torch.load(d / "diffusion_pytorch_model.bin", weights_only=True)
        st.save_file({k: v.numpy() for k, v in sd.items()}, str(d / "diffusion_pytorch_model.safetensors"))
        os.remove(d / "diffusion_pytorch_model.bin")
    loaded = TorchPipeline.from_pretrained(str(tmp_path / "p"), fused_groupnorm=True, device="cpu")
    _state_dicts_equal(loaded.unet, tpipe.unet)
    _state_dicts_equal(loaded.vqvae, tpipe.vqvae)

    encoder = TorchAudioEncoder()
    with torch.no_grad():
        for p in encoder.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    encoder.save_pretrained(str(tmp_path / "enc"))
    sd = torch.load(tmp_path / "enc" / "diffusion_pytorch_model.bin", weights_only=True)
    st.save_file({k: v.numpy() for k, v in sd.items()}, str(tmp_path / "enc" / "diffusion_pytorch_model.safetensors"))
    os.remove(tmp_path / "enc" / "diffusion_pytorch_model.bin")
    _state_dicts_equal(TorchAudioEncoder.from_pretrained(str(tmp_path / "enc"), device="cpu"), encoder)


@pytest.mark.parametrize("kw", [UNET_KW, COND_KW], ids=["unconditional", "conditional"])
def test_convert_checkpoint_round_trips(kw, tmp_path, fast_flax_templates):
    """diffusers -> ``--to native`` -> ``--to torch``: the weights come back
    bitwise, the native copy loads into the JAX package with the same params,
    and each run reports the layout it detected."""
    _, tpipe = _pair(kw, VAE_KW)
    tpipe.save_pretrained(str(tmp_path / "diffusers"))
    out = convert_checkpoint.main(["--input", str(tmp_path / "diffusers"), "--output", str(tmp_path / "native"),
                                   "--to", "native"])
    assert out["from"] == "torch" and out["format"] == "native" and out["latent"]
    back = convert_checkpoint.main(["--input", str(tmp_path / "native"), "--output", str(tmp_path / "torch"),
                                    "--to", "torch"])
    assert back["from"] == "native" and back["format"] == "torch"
    for sub in ("unet", "vqvae"):
        a = torch.load(tmp_path / "diffusers" / sub / "diffusion_pytorch_model.bin", weights_only=True)
        b = torch.load(tmp_path / "torch" / sub / "diffusion_pytorch_model.bin", weights_only=True)
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a), sub
    for name in ("unet/config.json", "vqvae/config.json", "model_index.json", "scheduler/scheduler_config.json"):
        assert (tmp_path / "torch" / name).read_text() == (tmp_path / "diffusers" / name).read_text(), name
    loaded_j = AudioDiffusionPipeline.from_pretrained(str(tmp_path / "native"))
    assert dataclasses.replace(loaded_j.unet.config, fused_groupnorm=False) == UNetConfig(
        **dict(kw, fused_groupnorm=False))
    want = convert.unet_params_from_state_dict(tpipe.unet.state_dict(), tpipe.unet.config)
    _leaves_equal(jax.tree.map(np.asarray, loaded_j.unet_params), want)


def test_remat_survives_both_layouts_and_the_converter(tmp_path):
    """``remat`` is set only through a config: a JAX pipeline saved with
    ``remat=True`` loads into the port with it, and every directory the port
    writes from there (diffusers and native layouts, ``convert_checkpoint --to
    native`` of the diffusers one) gives it back to the JAX package's
    ``UNetConfig.from_pretrained`` and to the port."""
    jpipe, _ = _pair(dict(UNET_KW, remat=True))
    jpipe.save_pretrained(str(tmp_path / "jax"))
    loaded = TorchPipeline.from_pretrained(str(tmp_path / "jax"), device="cpu")
    assert loaded.unet.config.remat
    loaded.save_pretrained(str(tmp_path / "diffusers"))
    loaded.save_pretrained(str(tmp_path / "native"), layout="native")
    convert_checkpoint.main(["--input", str(tmp_path / "diffusers"), "--output", str(tmp_path / "converted"),
                             "--to", "native"])
    for d in ("diffusers", "native", "converted"):
        assert UNetConfig.from_pretrained(str(tmp_path / d / "unet")).remat is True, d
        assert diffusers_io.read_unet(str(tmp_path / d / "unet"))[0].remat is True, d
    # a remat=False UNet's diffusers config stays as the JAX package's torch_export writes it
    assert "remat" not in diffusers_io.unet_config_to_diffusers(dataclasses.replace(loaded.unet.config, remat=False))
