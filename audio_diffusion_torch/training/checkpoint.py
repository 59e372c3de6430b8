"""Atomic train-state checkpoints (port of ``audio_diffusion_tpu/training/checkpoint.py``).

The layout is the JAX package's: ``<directory>/<step>/`` per checkpoint,
written into ``<step>.tmp`` and renamed into place (an interrupted save never
leaves a step directory behind), the oldest pruned beyond ``max_to_keep``.
The file is a ``torch.save`` of the train state as CPU tensors: the step,
the parameters, the optimizer's count and moments, the EMA parameters.
Restoring copies the saved tensors into the template state's own (so a
UNet's parameters are updated in place) and resumes the data stream exactly
(epoch shuffles derive from (seed, epoch), see ``data.dataset.epoch_rng``).
The JAX package's orbax backend, a TPU-pod path, has no counterpart.

Data parallel runs keep the file: whole tensors, whatever the world size, so
a checkpoint moves between 1 and N ranks either way. Saving gathers every
sharded tensor on every rank (a collective) and rank 0 alone writes;
restoring reads the file on every rank after a barrier and keeps each
rank's shard.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import gather_to_host, is_main_process, is_sharded, local

_STATE_FILE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    # ----------------------------------------------------------------- steps
    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: dict) -> None:
        """Write ``state`` (nested dicts of tensors and Python values) as checkpoint ``step``."""
        final_dir = os.path.join(self.directory, str(step))
        tmp_dir = final_dir + ".tmp"
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir)
        torch.save(_to_cpu(state), os.path.join(tmp_dir, _STATE_FILE))
        shutil.rmtree(final_dir, ignore_errors=True)
        os.rename(tmp_dir, final_dir)  # atomic publish
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved state of ``step`` (default the latest) on the CPU; None if there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, str(step), _STATE_FILE), map_location="cpu",
                          weights_only=True)


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_to_keep)


def train_state_dict(state) -> dict:
    """A ``train_unet.TrainState`` as nested dicts of tensors."""
    return {"step": int(state.step), "params": state.params,
            "opt_state": {"count": int(state.opt_state.count), "mu": state.opt_state.mu, "nu": state.opt_state.nu},
            "ema_params": state.ema_params}


def save_train_state(manager: CheckpointManager, step: int, state) -> None:
    """Every rank calls this (sharded tensors are gathered); rank 0 writes."""
    main = is_main_process()
    tree = gather_to_host(train_state_dict(state), keep=main)
    if main:
        manager.save(step, tree)


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` into ``dst``, or into this rank's shard of it."""
    if is_sharded(dst):
        from torch.distributed.tensor import distribute_tensor

        # every rank holds src: each keeps its own shard, no communication
        src = distribute_tensor(src.to(dst.device), dst.device_mesh, dst.placements, src_data_rank=None)
    local(dst).copy_(local(src))


@torch.no_grad()
def restore_train_state(manager: CheckpointManager, template, step: Optional[int] = None):
    """Copy checkpoint ``step`` (default the latest) into ``template``'s
    tensors in place and return it, or None when the directory holds none.
    Raises when the saved keys or shapes differ from the template's. Under a
    process group every rank calls it."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()  # rank 0's last save is on disk before anyone reads
    saved = manager.restore(step)
    if saved is None:
        return None
    pairs = [(template.params, saved["params"]), (template.opt_state.mu, saved["opt_state"]["mu"]),
             (template.opt_state.nu, saved["opt_state"]["nu"])]
    if (template.ema_params is None) != (saved["ema_params"] is None):
        raise ValueError("checkpoint and train state disagree on use_ema")
    if template.ema_params is not None:
        pairs.append((template.ema_params, saved["ema_params"]))
    for dst, src in pairs:
        if dst.keys() != src.keys() or any(dst[k].shape != src[k].shape for k in dst):
            raise ValueError(f"checkpoint {manager.directory}/{saved['step']} does not fit this model's parameters")
        for k, t in dst.items():
            _assign(t, src[k])
    template.step = int(saved["step"])
    template.opt_state.count = int(saved["opt_state"]["count"])
    return template
