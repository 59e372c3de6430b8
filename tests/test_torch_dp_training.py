"""Data-parallel training of the port on the CPU: 2 ranks of gloo, each a
process of its own (tests/torch_dp_worker.py, which imports no JAX),
rendezvoused through a ``file://`` in the test's directory so parallel test
workers never race for a port; every child has a timeout, so a hang fails.

* One DDP step and one FSDP step (2 ranks, each its 4 rows of a global
  microbatch of 8), with accumulation 1 and 2, against the JAX step on the
  8-device CPU mesh with the JAX draws injected (``tests/test_training.py``'s
  sharded-step gate, its hyperparameters): loss and grad_norm rtol 1e-5,
  parameters atol 1e-5, the gradients (Adam's first moment over 1 - b1)
  within 1e-4 of each tensor's largest; both ranks' loss bitwise equal.
* The seeded-generator step on 2 ranks against the port's one-device step
  with the same seed: loss rtol 1e-5, parameters atol 1e-5.
* The DDP and FSDP steps with ``remat`` (each block run again in the
  backward, inside FSDP2's units) against the same steps without it:
  bitwise, and no FSDP parameter left unsharded after the step.

The CLI in 2 processes and ``push_to_hub`` are in test_torch_dp_cli.py, on
this file's launcher.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_models import random_params

from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.training import train_unet as tt
from audio_diffusion_torch.utils.convert import unet_state_dict
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.parallel import make_mesh
from audio_diffusion_tpu.schedulers import DDPMScheduler
from audio_diffusion_tpu.training import train_unet as jt

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
# 32 and 64 channels: the larger convolutions are big enough for FSDP to split them on their own axes
UNET_KW = dict(sample_size=(8, 8), block_out_channels=(32, 64), down_block_types=("DownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=8)
TRAIN = dict(learning_rate=1e-3, lr_warmup_steps=1, total_steps=100)  # tests/test_training.py's sharded-step gate
MICRO = 8  # the global microbatch: 1 row per JAX device, 4 per port rank
SEED = 3
CASES = [dict(name=f"{sharding}-{accum}", sharding=sharding, accum=accum, injected=True)
         for sharding in ("replicated", "fsdp") for accum in (1, 2)]
CASES += [dict(name=f"{sharding}-generator", sharding=sharding, accum=2, injected=False)
          for sharding in ("replicated", "fsdp")]
CASES += [dict(name=f"{sharding}-remat", sharding=sharding, accum=2, injected=True, remat=True)
          for sharding in ("replicated", "fsdp")]


def _launch(work, mode, tag, timeout=240):
    """Start 2 ranks of ``mode``; returns a function that waits for them."""
    rendezvous = os.path.join(work, f"rendezvous_{tag}")
    logs = [open(os.path.join(work, f"{tag}_{rank}.log"), "w") for rank in range(2)]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), "2", rendezvous, mode, work], stdout=log,
                              stderr=subprocess.STDOUT, env=env) for rank, log in enumerate(logs)]

    def wait():
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise AssertionError("rank timeout\n" + "\n".join(open(log.name).read()[-3000:] for log in logs))
        finally:
            for log in logs:
                log.close()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"rank rc={p.returncode}\n{open(log.name).read()[-4000:]}"

    return wait


def _jax_draws(key, accum):
    """The JAX step's draws (train_unet.py:209-221): split(key, accum), then per microbatch split(k, 3)."""
    t, noise = [], []
    for k in jax.random.split(key, accum):
        t_key, n_key, _ = jax.random.split(k, 3)
        t.append(np.asarray(jax.random.randint(t_key, (MICRO,), 0, 1000)))
        noise.append(np.asarray(jax.random.normal(n_key, (MICRO, 8, 8, 1))))
    return np.stack(t), np.stack(noise)


def _jax_step(params, images, key, sharding, accum):
    """jt.make_train_step on the 8-device mesh: loss, grad_norm, parameters and Adam's mu, in the port's layout."""
    cfg_kw = dict(TRAIN, gradient_accumulation_steps=accum, param_sharding=sharding)
    cfg = jt.TrainConfig(**cfg_kw)
    unet = UNet2D(UNetConfig(**UNET_KW))
    mesh = make_mesh()
    state = jt.shard_train_state(jt.init_train_state(cfg, params), mesh, cfg)
    img_sh, _ = jt.batch_shardings(mesh)
    new, metrics = jt.make_train_step(cfg, unet, DDPMScheduler())(state, jax.device_put(images, img_sh), None, key)
    tree = lambda t: unet_state_dict(jax.tree_util.tree_map(np.asarray, t), unet.config)  # noqa: E731
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "params": tree(new.params),
            "mu": tree(new.opt_state[1][0].mu)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank DDP and FSDP steps of every case, started together; the JAX steps run meanwhile."""
    work = str(tmp_path_factory.mktemp("dp"))
    cfg = UNetConfig(**UNET_KW)
    params = random_params(UNet2D(cfg).init_params, 1)
    rng = np.random.default_rng(2)
    inputs = {f"w.{k}": v for k, v in unet_state_dict(params, cfg).items()}
    keys = {accum: jax.random.key(9 + accum) for accum in (1, 2)}
    for accum in (1, 2):
        inputs[f"images{accum}"] = rng.uniform(-1, 1, (accum, MICRO, 8, 8, 1)).astype(np.float32)
        inputs[f"t{accum}"], inputs[f"noise{accum}"] = _jax_draws(keys[accum], accum)
    np.savez(os.path.join(work, "steps_inputs.npz"), **inputs)
    json.dump({"unet": UNET_KW, "train": TRAIN, "seed": SEED, "cases": CASES},
              open(os.path.join(work, "steps.json"), "w"))

    wait = _launch(work, "steps", "steps")
    jax_ref = {(sharding, accum): _jax_step(params, inputs[f"images{accum}"], keys[accum], sharding, accum)
               for sharding, accum in (("replicated", 1), ("fsdp", 2))}
    wait()
    return {"work": work, "inputs": inputs, "jax": jax_ref,
            "steps": {c["name"]: [dict(np.load(os.path.join(work, f"steps_{c['name']}_{rank}.npz")))
                                  for rank in range(2)] for c in CASES}}


def _assert_gradients_close(got_mu, want_mu):
    """The first step's gradients, from Adam's first moment (mu = (1 - b1) g):
    each tensor within 1e-4 of its largest. The mid attention's to_k bias gets
    a zero gradient in exact arithmetic (softmax ignores a shift shared by
    every key): there both sides must be rounding noise, under 1e-6 of the
    largest gradient."""
    b1 = jt.TrainConfig().adam_beta1
    got = {k: v / (1 - b1) for k, v in got_mu.items()}
    want = {k: v / (1 - b1) for k, v in want_mu.items()}
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        if k.endswith("to_k.bias"):
            assert np.abs(g).max() <= noise and np.abs(want[k]).max() <= noise, k
        else:
            assert np.abs(g - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


def _port_params(out):
    return {k[2:]: v for k, v in out.items() if k.startswith("p.")}


@pytest.mark.parametrize("case", [c["name"] for c in CASES if c["injected"] and not c.get("remat")])
def test_dp_step_matches_the_jax_mesh_step(runs, case):
    sharding, accum = case.split("-")
    accum = int(accum)
    want = runs["jax"][("replicated", 1) if accum == 1 else ("fsdp", 2)]
    rank0, rank1 = runs["steps"][case]
    assert rank0["loss"] == rank1["loss"] and rank0["grad_norm"] == rank1["grad_norm"]  # the global mean, everywhere
    for name in ("loss", "grad_norm"):
        assert abs(float(rank0[name]) - want[name]) <= 1e-5 * abs(want[name]), (name, float(rank0[name]), want[name])
    params = _port_params(rank0)
    assert params.keys() == want["params"].keys()
    for k, v in params.items():
        np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=1e-5, err_msg=k)
    # the update of the first step runs at lr 0 (warmup), so the gradients are read from Adam's first moment
    mu = {k[3:]: v for k, v in rank0.items() if k.startswith("mu.")}
    assert mu.keys() == want["mu"].keys()
    _assert_gradients_close(mu, want["mu"])


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_dp_generator_step_is_the_one_device_step(runs, sharding):
    """Each rank draws the whole microbatch from step_generator(seed, step) and keeps its rows."""
    inputs = runs["inputs"]
    unet = TorchUNet(TorchUNetConfig(**UNET_KW))
    unet.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("w.")}, strict=True)
    cfg = tt.TrainConfig(**TRAIN, gradient_accumulation_steps=2, param_sharding=sharding)
    state = tt.init_train_state(cfg, unet.train())
    state, metrics = tt.make_train_step(cfg, unet, TorchDDPM())(state, inputs["images2"], seed=SEED)
    rank0, rank1 = runs["steps"][f"{sharding}-generator"]
    assert rank0["loss"] == rank1["loss"]
    assert abs(float(rank0["loss"]) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    for k, v in _port_params(rank0).items():
        np.testing.assert_allclose(v, state.params[k].detach().numpy(), rtol=0, atol=1e-5, err_msg=k)
    _assert_gradients_close({k[3:]: v for k, v in rank0.items() if k.startswith("mu.")},
                            {k: v.numpy() for k, v in state.opt_state.mu.items()})


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_dp_remat_step_is_the_full_memory_step(runs, sharding):
    """Under FSDP2 the recompute calls each sharded resnet again inside the
    backward: its parameters must be gathered once more, reduced once and
    sharded again, so loss, grad_norm, parameters and Adam's first moment
    equal the step without remat bitwise, and no parameter stays unsharded."""
    for got, want in zip(runs["steps"][f"{sharding}-remat"], runs["steps"][f"{sharding}-2"]):
        assert got.keys() == want.keys() and int(got["unsharded"]) == int(want["unsharded"]) == 0
        for k in got:
            assert np.array_equal(got[k], want[k]), k
