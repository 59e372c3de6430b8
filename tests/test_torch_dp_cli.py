"""Data-parallel training of the port on the CPU, continued from
test_torch_dp_training.py (its 2-rank gloo launcher and tiny UNet):

* The CLI in 2 processes with FSDP (``tests/test_multiprocess.py``'s run): 5
  steps, then resumed to 8; both ranks give the same loss bitwise, rank 0
  alone saves, and the loss is within rtol 1e-4 of a one-process 8-step run;
  the 5-step FSDP checkpoint resumes in one process.
* ``push_to_hub`` stops both ranks, with no hang.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_dp_training import UNET_KW, _launch

from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_torch.training import checkpoint as tckpt
from audio_diffusion_torch.training import train_unet as tt
from audio_diffusion_torch.training.loop import RunConfig, run_training

RES = 16  # the CLI run's slices
CLI_UNET = dict(UNET_KW, sample_size=(RES, RES))


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
    """The 2-rank CLI for 5 steps and the push, started together; then the CLI resumed to 8."""
    work = str(tmp_path_factory.mktemp("dp_cli"))
    _slices(os.path.join(work, "ds"), 16)  # 2 optimizer steps per epoch at a microbatch of 8
    unet = TorchUNet(TorchUNetConfig(**CLI_UNET)).init_params(torch.Generator().manual_seed(0))
    TorchPipeline(unet, TorchMel(x_res=RES, y_res=RES, device="cpu"), TorchDDIM(TorchSchedulerConfig(100)),
                  device="cpu").save_pretrained(os.path.join(work, "seed"))
    json.dump(_cli_args(work, 5), open(os.path.join(work, "cli.json"), "w"))
    json.dump(dict(dataset=os.path.join(work, "ds"), output_dir=os.path.join(work, "pushed"), push_to_hub=True,
                   device="cpu"), open(os.path.join(work, "push.json"), "w"))
    for wait in [_launch(work, "cli", "cli5"), _launch(work, "push", "push")]:
        wait()
    results = {"work": work,
               "cli5": [json.load(open(os.path.join(work, f"cli_{rank}.json"))) for rank in range(2)],
               "push": [json.load(open(os.path.join(work, f"push_{rank}.json"))) for rank in range(2)]}
    shutil.copytree(os.path.join(work, "model"), os.path.join(work, "model_at_5"))
    json.dump(_cli_args(work, 8), open(os.path.join(work, "cli.json"), "w"))
    _launch(work, "cli", "cli8")()
    results["cli8"] = [json.load(open(os.path.join(work, f"cli_{rank}.json"))) for rank in range(2)]
    return results


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
