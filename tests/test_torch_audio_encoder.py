"""Port parity of the AudioEncoder on the CPU, at full width (the 41,472 ->
1,024 dense layer): the same seeded flax variables, BatchNorm running
statistics perturbed away from 0 and 1 so they reach the output, go through
both packages. Tolerance 1e-4 on the embeddings. The two Mels give bit-equal
uint8 images, so ``encode`` on the same raw audio agrees to the same bound
for every pooling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import random_params

from audio_diffusion_torch.models import AudioEncoder as TorchEncoder
from audio_diffusion_torch.utils.convert import audio_encoder_state_dict, to_torch
from audio_diffusion_tpu.models.audio_encoder import AudioEncoder
from audio_diffusion_tpu.utils.torch_import import convert_audio_encoder, load_audio_encoder


@pytest.fixture(scope="module")
def encoders():
    enc = AudioEncoder()
    shapes = jax.eval_shape(enc.init_variables, jax.random.key(0))
    rng = np.random.default_rng(41)

    def perturbed(path, s):  # running mean ~ N(0, 0.01), variance ~ U(0.5, 1.5)
        if path[-1].key == "mean":
            return 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(perturbed, shapes["batch_stats"])
    variables = {"params": random_params(lambda k: enc.init_variables(k)["params"], 40), "batch_stats": stats}
    port = TorchEncoder()
    port.load_state_dict(to_torch(audio_encoder_state_dict(variables)), strict=True)
    return enc, variables, port.eval()


def test_state_dict_is_the_importers_inverse(encoders):
    _, variables, port = encoders
    sd = audio_encoder_state_dict(variables)
    assert sorted(sd) == sorted(port.state_dict())
    back = convert_audio_encoder(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v, np.float32)
                      for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(variables), flat(back)
    assert sorted(want) == sorted(got) and all(np.array_equal(want[k], got[k]) for k in want)


def test_forward_matches_flax(encoders):
    enc, variables, port = encoders
    x = np.random.default_rng(42).uniform(0, 1, (3, 96, 216)).astype(np.float32)
    want = np.asarray(jax.jit(enc.apply)(variables, jnp.asarray(x[..., None])))
    port.train()  # inference only: BatchNorm reads its running statistics in either mode
    with torch.no_grad():
        got = port(torch.from_numpy(x[:, None])).numpy()
    assert got.shape == want.shape == (3, 100)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _clips():
    """One clip of 10 s (one 216-frame slice) and one of three slices."""
    rng = np.random.default_rng(43)
    out = []
    for seconds, f in ((10.0, 220.0), (3 * 216 * 512 / 22050 + 0.1, 660.0)):
        t = np.arange(int(seconds * 22050)) / 22050
        out.append((0.5 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal(t.size)).astype(np.float32))
    return out


@pytest.mark.parametrize("pool", ["average", "max", None])
def test_encode_matches_jax(encoders, pool):
    enc, variables, port = encoders
    clips = _clips()
    want = enc.encode(variables, clips, pool=pool)
    got = port.encode(clips, pool=pool)
    if pool is None:
        assert [g.shape for g in got] == [w.shape for w in want] == [(1, 100), (3, 100)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    else:
        assert got.shape == want.shape == (2, 100)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_save_pretrained_loads_in_both_packages(encoders, tmp_path, monkeypatch):
    enc, variables, port = encoders
    port.save_pretrained(str(tmp_path))
    loaded = TorchEncoder.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.config == port.config
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    # The JAX loader checks against a template from flax's init, which only needs its shapes.
    monkeypatch.setattr(AudioEncoder, "init_variables", lambda self, key: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: self.init(k, jnp.zeros((1, 96, 216, 1))), key)))
    _, loaded_j = load_audio_encoder(str(tmp_path))
    x = jnp.asarray(np.random.default_rng(44).uniform(0, 1, (2, 96, 216, 1)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jax.jit(enc.apply)(loaded_j, x)),
                                  np.asarray(jax.jit(enc.apply)(variables, x)))
    with pytest.raises(ValueError, match="Unknown pooling"):
        port.encode(_clips()[:1], pool="median")
