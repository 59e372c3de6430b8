"""One rank of the port's data-parallel tests (tests/test_torch_dp_training.py).

    python tests/torch_dp_worker.py RANK WORLD RENDEZVOUS_FILE MODE WORKDIR

Joins a gloo group on the CPU through ``file://RENDEZVOUS_FILE`` and runs
MODE with the files in WORKDIR. Imports torch and the port only, never JAX.
Not collected by pytest.

* ``steps``: every case of ``steps.json`` (param_sharding, accum, injected
  draws or the seeded generator, ``remat``) from the weights, images and
  draws of ``steps_inputs.npz``; each case takes one optimizer step on this
  rank's rows and writes its loss, grad_norm, the number of the UNet's
  parameters left unsharded after the step and (rank 0) the whole updated
  parameters and Adam first moments into ``steps_<case>_<rank>.npz``.
* ``cli``: ``audio_diffusion_torch.training.__main__.main`` on the argv of
  ``cli.json``, inside the group; the result goes to ``cli_<rank>.json``.
* ``push``: ``run_training`` with ``push_to_hub``; the error goes to
  ``push_<rank>.json``.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _steps(work: str, rank: int) -> None:
    import torch
    from torch.distributed.tensor import DTensor

    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.parallel import batch_slice, gather_to_host, world
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training import train_unet as tt

    spec = json.load(open(os.path.join(work, "steps.json")))
    data = np.load(os.path.join(work, "steps_inputs.npz"))
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("w.")}
    _, world_size = world()
    for case in spec["cases"]:
        unet = UNet2D(UNetConfig(**spec["unet"], remat=case.get("remat", False)))
        unet.load_state_dict(weights, strict=True)
        cfg = tt.TrainConfig(**spec["train"], gradient_accumulation_steps=case["accum"],
                             param_sharding=case["sharding"])
        model = tt.wrap_unet(cfg, unet.train())
        state = tt.init_train_state(cfg, model)
        step = tt.make_train_step(cfg, model, DDPMScheduler())
        images = data[f"images{case['accum']}"]
        rows = batch_slice(images.shape[1], rank, world_size)
        draws = {}
        if case["injected"]:
            draws = {"timesteps": data[f"t{case['accum']}"], "noise": data[f"noise{case['accum']}"]}
        state, metrics = step(state, images[:, rows], seed=spec["seed"], **draws)
        params = gather_to_host(state.params, keep=rank == 0)
        mu = gather_to_host(state.opt_state.mu, keep=rank == 0)
        unsharded = sum(not isinstance(p, DTensor) for p in unet.parameters()) if case["sharding"] == "fsdp" else 0
        out = {"loss": np.float32(metrics["loss"]), "grad_norm": np.float32(metrics["grad_norm"]),
               "unsharded": np.int64(unsharded)}
        if rank == 0:
            out.update({f"p.{k}": v.numpy() for k, v in params.items()})
            out.update({f"mu.{k}": v.numpy() for k, v in mu.items()})
        np.savez(os.path.join(work, f"steps_{case['name']}_{rank}.npz"), **out)


def _cli(work: str, rank: int) -> None:
    from audio_diffusion_torch.training.__main__ import main

    result = main(json.load(open(os.path.join(work, "cli.json"))))
    with open(os.path.join(work, f"cli_{rank}.json"), "w") as fh:
        json.dump(result, fh)


def _push(work: str, rank: int) -> None:
    from audio_diffusion_torch.training import RunConfig, TrainConfig, run_training

    run = RunConfig(**json.load(open(os.path.join(work, "push.json"))))
    try:
        run_training(run, TrainConfig())
        message = None
    except RuntimeError as e:
        message = str(e)
    with open(os.path.join(work, f"push_{rank}.json"), "w") as fh:
        json.dump({"push_error": message}, fh)


def main() -> None:
    rank, world_size, rendezvous, mode, work = sys.argv[1:6]
    rank, world_size = int(rank), int(world_size)
    import torch

    torch.set_num_threads(1)
    from audio_diffusion_torch.parallel import init_distributed

    assert init_distributed(f"file://{rendezvous}", world_size, rank, device="cpu", timeout_s=120) == rank
    import torch.distributed as dist

    try:
        {"steps": _steps, "cli": _cli, "push": _push}[mode](work, rank)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[rank {rank}] {mode} done", flush=True)


if __name__ == "__main__":
    main()
