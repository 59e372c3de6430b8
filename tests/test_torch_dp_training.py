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
* The CLI in 2 processes with FSDP (``tests/test_multiprocess.py``'s run): 5
  steps, then resumed to 8; both ranks give the same loss bitwise, rank 0
  alone saves, and the loss is within rtol 1e-4 of a one-process 8-step run;
  the 5-step FSDP checkpoint resumes in one process.
* ``push_to_hub`` stops both ranks, with no hang.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import random_params

from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_torch.training import checkpoint as tckpt
from audio_diffusion_torch.training import train_unet as tt
from audio_diffusion_torch.training.loop import RunConfig, run_training
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
RES = 16  # the CLI run's slices
CLI_UNET = dict(UNET_KW, sample_size=(RES, RES))


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


def _slices(directory, n):
    os.makedirs(directory)
    rng = np.random.default_rng(0)
    for i in range(n):
        image = Image.fromarray(rng.integers(0, 256, (RES, RES), dtype=np.uint8))
        image.save(os.path.join(directory, f"s_{i:02d}.png"))


def _cli_args(work, max_steps, out="model"):
    return ["--device", "cpu", "--dataset", os.path.join(work, "ds"), "--output_dir", os.path.join(work, out),
            "--from_pretrained", os.path.join(work, "seed"), "--train_batch_size", "8", "--eval_batch_size", "2",
            "--num_epochs", "50", "--save_images_epochs", "1000", "--save_model_epochs", "4",
            "--scheduler", "ddim", "--num_train_steps", "100", "--lr_warmup_steps", "2", "--seed", "11",
            "--param_sharding", "fsdp", "--mesh_data", "2", "--max_steps", str(max_steps)]


def _run_config(work, max_steps, out):
    return RunConfig(dataset=os.path.join(work, "ds"), output_dir=os.path.join(work, out), num_epochs=50,
                     train_batch_size=8, eval_batch_size=2, save_images_epochs=1000, save_model_epochs=4,
                     scheduler="ddim", num_train_steps=100, from_pretrained=os.path.join(work, "seed"), seed=11,
                     max_steps=max_steps, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank launch of this file, started together; the JAX steps run meanwhile."""
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

    _slices(os.path.join(work, "ds"), 16)  # 2 optimizer steps per epoch at a microbatch of 8
    unet = TorchUNet(TorchUNetConfig(**CLI_UNET)).init_params(torch.Generator().manual_seed(0))
    TorchPipeline(unet, TorchMel(x_res=RES, y_res=RES, device="cpu"), TorchDDIM(TorchSchedulerConfig(100)),
                  device="cpu").save_pretrained(os.path.join(work, "seed"))
    json.dump(_cli_args(work, 5), open(os.path.join(work, "cli.json"), "w"))
    json.dump(dict(dataset=os.path.join(work, "ds"), output_dir=os.path.join(work, "pushed"), push_to_hub=True,
                   device="cpu"), open(os.path.join(work, "push.json"), "w"))

    waits = [_launch(work, "steps", "steps"), _launch(work, "cli", "cli5"), _launch(work, "push", "push")]
    jax_ref = {(sharding, accum): _jax_step(params, inputs[f"images{accum}"], keys[accum], sharding, accum)
               for sharding, accum in (("replicated", 1), ("fsdp", 2))}
    for wait in waits:
        wait()

    results = {"work": work, "inputs": inputs, "jax": jax_ref,
               "cli5": [json.load(open(os.path.join(work, f"cli_{rank}.json"))) for rank in range(2)],
               "push": [json.load(open(os.path.join(work, f"push_{rank}.json"))) for rank in range(2)]}
    shutil.copytree(os.path.join(work, "model"), os.path.join(work, "model_at_5"))
    json.dump(_cli_args(work, 8), open(os.path.join(work, "cli.json"), "w"))
    _launch(work, "cli", "cli8")()
    results["cli8"] = [json.load(open(os.path.join(work, f"cli_{rank}.json"))) for rank in range(2)]
    results["steps"] = {c["name"]: [dict(np.load(os.path.join(work, f"steps_{c['name']}_{rank}.npz")))
                                    for rank in range(2)] for c in CASES}
    return results


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


@pytest.mark.parametrize("case", [c["name"] for c in CASES if c["injected"]])
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


def test_two_process_cli_with_resume_and_parity(runs):
    work = runs["work"]
    for phase, steps in (("cli5", 5), ("cli8", 8)):
        rank0, rank1 = runs[phase]
        assert rank0["steps"] == rank1["steps"] == steps
        assert (rank0["world_size"], rank1["world_size"], rank0["rank"], rank1["rank"]) == (2, 2, 0, 1)
        assert rank0["loss"] == rank1["loss"] and rank0["losses"] == rank1["losses"]  # bitwise on both ranks
        assert rank0["saves"] >= 1 and rank1["saves"] == 0  # rank 0 alone writes
    assert len(runs["cli8"][0]["losses"]) == 3  # resumed at 5
    assert tckpt.make_manager(os.path.join(work, "model", "checkpoints")).all_steps()[-1] == 8
    assert "'steps': 8" in open(os.path.join(work, "cli8_0.log")).read()  # rank 0 alone prints the result
    assert "'steps': 8" not in open(os.path.join(work, "cli8_1.log")).read()
    single = run_training(_run_config(work, 8, "model_single"), tt.TrainConfig(lr_warmup_steps=2))
    assert single["steps"] == 8
    np.testing.assert_allclose(single["loss"], runs["cli8"][0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(single["losses"][5:], runs["cli8"][0]["losses"], rtol=1e-4)
    np.testing.assert_allclose(single["losses"][:5], runs["cli5"][0]["losses"], rtol=1e-4)
    pipe = TorchPipeline.from_pretrained(os.path.join(work, "model"), device="cpu")
    assert pipe(batch_size=1, steps=2, return_images_only=True).shape == (1, RES, RES)


def test_fsdp_checkpoint_resumes_on_one_device(runs):
    """The 2-rank FSDP checkpoint at step 5 holds whole tensors: one process resumes it to step 8."""
    work = runs["work"]
    resumed = run_training(_run_config(work, 8, "model_at_5"), tt.TrainConfig(lr_warmup_steps=2))
    assert resumed["steps"] == 8 and len(resumed["losses"]) == 3
    np.testing.assert_allclose(resumed["losses"], runs["cli8"][0]["losses"], rtol=1e-4)


def test_push_to_hub_stops_both_ranks(runs):
    rank0, rank1 = runs["push"]
    assert "cannot be created" in rank0["push_error"]  # the Hub error itself
    assert "aborting this process too" in rank1["push_error"]  # rank 0's outcome, broadcast
    assert not os.path.exists(os.path.join(runs["work"], "pushed", "checkpoints"))
