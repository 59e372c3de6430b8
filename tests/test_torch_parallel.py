"""Port parity of ``parallel/`` and of the AudioEncoder's train mode on the CPU.

The mesh shapes and errors; ``batch_slice`` against the rows each device of
the JAX package's ``batch_shardings`` holds on the 8-device CPU mesh;
``fsdp_sharding_for`` against the JAX rule on every parameter of a small
UNet, through ``utils/convert.py``'s layout map (the port picks the same
tensor axis, and keeps the same parameters whole); the single-process
defaults; and the AudioEncoder's ``train=True`` against flax's
``apply(..., train=True, mutable=["batch_stats"])`` with the dropout rates at
0 (output within 1e-5 of its largest value, running statistics within
1e-5), its dropout, and ``encode`` untouched by ``.train()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_params

from audio_diffusion_torch.models import AudioEncoder as TorchEncoder
from audio_diffusion_torch.models.audio_encoder import AudioEncoderConfig as TorchEncoderConfig
from audio_diffusion_torch.models.audio_encoder import _dropout
from audio_diffusion_torch.parallel import mesh as tmesh
from audio_diffusion_torch.utils.convert import audio_encoder_state_dict, to_torch, unet_state_dict
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.audio_encoder import AudioEncoder, AudioEncoderConfig
from audio_diffusion_tpu.parallel import mesh as jmesh
from audio_diffusion_tpu.training.train_unet import batch_shardings

UNET_KW = dict(sample_size=(8, 8), block_out_channels=(64, 128), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
               up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=8,
               attention_head_dim=8)
# narrow widths at the reference's 96 x 216 mel: flatten 12 * 27 * 16 = 5,184
ENCODER_KW = dict(channels=(4, 8, 16), dense_features=32, embedding_dim=10)


def test_make_mesh_shapes_and_errors():
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    assert dict(mesh.shape) == {"data": 4, "model": 1} == dict(jmesh.make_mesh(num_data=4,
                                                                              devices=jax.devices()[:4]).shape)
    assert mesh.axis_names == ("data", "model") and mesh.devices.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)  # a device may repeat
    grid = tmesh.make_mesh(num_data=2, num_model=2, devices=["cpu"] * 4)
    assert dict(grid.shape) == {"data": 2, "model": 2} and grid.devices.shape == (2, 2)
    assert dict(tmesh.make_mesh(num_model=2, devices=["cpu"] * 4).shape)["data"] == 2
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        tmesh.make_mesh(num_data=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh 2x3 != 4 devices"):
        tmesh.make_mesh(num_data=2, num_model=3, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_batch_slice_is_the_rows_of_the_jax_batch_sharding():
    mesh = jmesh.make_mesh(num_data=8)
    img_sh, enc_sh = batch_shardings(mesh)
    images = jax.device_put(np.zeros((2, 16, 4, 4, 1), np.float32), img_sh)
    encodings = jax.device_put(np.zeros((2, 16, 1, 3), np.float32), enc_sh)
    for arr in (images, encodings):
        held = {shard.device: shard.index for shard in arr.addressable_shards}
        for rank, device in enumerate(mesh.devices[:, 0]):
            index = held[device]
            assert index[0] == slice(None)  # accumulation stays whole
            assert index[1] == tmesh.batch_slice(16, rank, 8)
    assert tmesh.batch_slice(6, 0, 1) == slice(0, 6)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_slice(6, 0, 4)


def _axis_tree(params, pick):
    """Each leaf replaced by the index along the axis ``pick(shape)`` names (0 everywhere when None)."""
    def leaf(x):
        shape = np.shape(x)
        axis = pick(shape)
        out = np.zeros(shape, np.float32)
        if axis is not None:
            view = [1] * len(shape)
            view[axis] = shape[axis]
            out += np.arange(shape[axis], dtype=np.float32).reshape(view)
        return out
    return jax.tree_util.tree_map(leaf, params)


@pytest.mark.parametrize("world, min_size", [(2, 2**14), (8, 2**14), (2, 2**6), (4, 2**6)])
def test_fsdp_axis_names_the_jax_tensor_axis(world, min_size):
    """The JAX choice, marked on each flax leaf and carried through the
    port's layout map, is the axis the port picks on the port's shape; the
    smaller ``min_size`` reaches the 2-D dense weights and the ties between a
    conv's in and out channels."""
    cfg = UNetConfig(**UNET_KW)
    params = jax.eval_shape(UNet2D(cfg).init_params, jax.random.key(0))
    mesh = jmesh.make_mesh(num_data=world, devices=jax.devices()[:world])

    def jax_axis(shape):
        spec = tuple(jmesh.fsdp_sharding_for(shape, mesh, min_size).spec)
        return spec.index("data") if "data" in spec else None

    marked = unet_state_dict(_axis_tree(params, jax_axis), cfg)
    sharded = 0
    for name, arr in marked.items():
        axis = tmesh.fsdp_sharding_for(arr.shape, world, min_size)
        varying = [a for a in range(arr.ndim) if arr.shape[a] > 1 and not np.all(arr.max(axis=a) == arr.min(axis=a))]
        if axis is None:
            assert varying == [] or arr.max() == 0, name  # the JAX rule left it whole too
        else:
            assert varying == [axis], (name, arr.shape, axis, varying)
            assert arr.shape[axis] % world == 0
            sharded += 1
    assert sharded > 0


def test_single_process_defaults():
    assert tmesh.init_distributed(device="cpu") == 0  # no group, no torchrun environment
    assert tmesh.world() == (0, 1) and tmesh.is_main_process()
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    t = torch.arange(3.0)
    tree = tmesh.gather_to_host({"a": t, "b": {"c": t}, "n": 4})
    assert torch.equal(tree["b"]["c"], t) and tree["a"] is not t and tree["n"] == 4
    assert tmesh.gather_to_host({"a": t}, keep=False) == {"a": None}
    with pytest.raises(ValueError, match="needs world_size and rank"):
        tmesh.init_distributed("tcp://127.0.0.1:1", device="cpu")


# --------------------------------------------------------------- AudioEncoder train mode

def _encoders(dropout=0.0, seed=4):
    kw = dict(ENCODER_KW, dropout_rates=(dropout,) * 3, dense_dropout=dropout)
    enc = AudioEncoder(AudioEncoderConfig(**kw))
    shapes = jax.eval_shape(enc.init_variables, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def perturbed(path, s):  # running mean ~ N(0, 0.01), variance ~ U(0.5, 1.5)
        if path[-1].key == "mean":
            return 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)

    variables = {"params": random_params(lambda k: enc.init_variables(k)["params"], seed),
                 "batch_stats": jax.tree_util.tree_map_with_path(perturbed, shapes["batch_stats"])}
    port = TorchEncoder(TorchEncoderConfig(**kw))
    port.load_state_dict(to_torch(audio_encoder_state_dict(variables)), strict=True)
    return enc, variables, port


def test_encoder_train_mode_matches_flax():
    enc, variables, port = _encoders()
    x = np.random.default_rng(5).uniform(0, 1, (4, 96, 216)).astype(np.float32)
    out, mutated = jax.jit(lambda v, x: enc.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x[..., None]))
    port.eval()  # the argument decides the mode, not .training
    got = port(torch.from_numpy(x[:, None]), train=True)
    want = np.asarray(out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    new = audio_encoder_state_dict({"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    sd = port.state_dict()
    stats = [k for k in new if "running" in k]
    assert len(stats) == 8
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), new[k], rtol=0, atol=1e-5, err_msg=k)
    old = audio_encoder_state_dict(variables)
    assert all(not np.allclose(sd[k].numpy(), old[k]) for k in stats)
    got.sum().backward()  # train mode is differentiable end to end
    assert all(p.grad is not None for p in port.parameters())


def test_encoder_dropout_acts_only_in_train_mode():
    _, _, port = _encoders(dropout=0.4)
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 1, 96, 216)).astype(np.float32))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    with torch.no_grad():
        inference = port(x)
        assert torch.equal(inference, port(x, train=False))
        assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())  # no statistics moved
        a = port(x, train=True, generator=torch.Generator().manual_seed(1))
        b = port(x, train=True, generator=torch.Generator().manual_seed(1))
        c = port(x, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(a, inference) and not torch.equal(a, c)
    assert torch.allclose(a, b)  # the masks come from the generator (the statistics moved between calls)
    ones = torch.ones(200_000)
    kept = _dropout(ones, 0.3, True, torch.Generator().manual_seed(0))
    values = kept.unique().tolist()
    assert values[0] == 0.0 and values[1] == pytest.approx(1 / 0.7) and len(values) == 2
    assert abs((kept == 0).float().mean().item() - 0.3) < 0.01
    assert _dropout(ones, 0.3, False, None) is ones and _dropout(ones, 0.0, True, None) is ones


def test_encode_is_untouched_by_train():
    _, _, port = _encoders(dropout=0.5, seed=7)
    clip = np.random.default_rng(8).standard_normal(96_000).astype(np.float32) * 0.1
    port.eval()
    want = port.encode([clip])
    port.train()
    got = port.encode([clip])
    assert got.shape == (1, 10) and torch.equal(got, want)
