"""Process groups, the inference mesh and the sharding rules (port of ``audio_diffusion_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ('data', 'model') mesh of
devices. torch runs one process per card: training is data parallel over
``torch.distributed`` (DDP, or FSDP2's ``fully_shard``; see
``training/train_unet.py``), and each rank holds its contiguous share of the
microbatch. Inference is one process: :func:`make_mesh` lists the devices
that ``AudioDiffusionPipeline.shard`` puts one replica on, and every batch
splits along the ``data`` axis.

* :func:`init_distributed` joins (or starts) the default process group: NCCL
  for CUDA, gloo for the CPU, rendezvous by ``tcp://host:port``,
  ``file://path`` or the ``torchrun`` environment.
* :func:`fsdp_sharding_for` is the JAX package's FSDP rule on the port's
  layout: the largest axis divisible by the data size, ties broken in the
  flax layout's axis order, so the same tensor axis is chosen.
* :func:`batch_slice` is the rows of ``P(None, "data")`` that one rank holds.
* :func:`gather_to_host` collects (possibly sharded) tensors on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> int:
    """Join the default process group and return this process's rank.

    ``init_method`` is ``tcp://host:port`` or ``file://path`` with
    ``world_size`` and ``rank``; when it is None the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) is read, as
    ``jax.distributed.initialize()`` auto-detects its cluster. Without either
    it is a single process: no group is made and the rank is 0.

    ``device`` "cuda" puts the rank on ``cuda:{LOCAL_RANK}`` (without
    ``LOCAL_RANK``: the rank modulo the card count) and takes NCCL; "cuda:i"
    pins the card; "cpu" takes gloo. ``backend`` overrides the choice (gloo on
    CUDA tensors supports the all-reduce and broadcast DDP needs, not FSDP's
    all-gather). A group that already exists is kept."""
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None:
        world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
        rank = rank if rank is not None else _env_int("RANK")
        if world_size is None or rank is None:
            return 0  # one process, no group
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError(f"init_distributed({init_method!r}) needs world_size and rank")
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA device requested but torch.cuda is not available; "
                               "pass device='cpu' to join a gloo group on the CPU")
        if dev.index is None:
            local = _env_int("LOCAL_RANK")
            dev = torch.device("cuda", local if local is not None else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
        if backend == "nccl":
            kw["device_id"] = dev
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank()


def world() -> tuple:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank-0 gating for logs, saves and samples (the reference's
    ``accelerator.is_main_process``)."""
    return world()[0] == 0


def rank_device(device: str) -> torch.device:
    """``device`` as this process uses it: a bare "cuda" is the current card
    (the rank's, once :func:`init_distributed` set it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# ------------------------------------------------------------------- inference mesh

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'model') grid of torch devices. ``shape`` is a dict, so
    ``dict(mesh.shape)["data"]`` reads as it does on a JAX mesh."""

    devices: np.ndarray  # (num_data, num_model) object array of torch.device
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (default: every local card).

    A device may repeat: JAX meshes span distinct devices, and the CPU tests
    fake 8 of them, but torch has one CPU device and a one-card machine one
    GPU, so ``devices=["cpu", "cpu"]`` or ``["cuda:0", "cuda:0"]`` is how a
    two-way split is run there."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', ...] to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [rank_device(str(d)) for d in devices]
    if num_data is None:
        num_data = devs.size // num_model
    if num_data < 1 or num_model < 1 or num_data * num_model != devs.size:
        raise ValueError(f"mesh {num_data}x{num_model} != {devs.size} devices")
    return Mesh(devs.reshape(num_data, num_model))


def batch_slice(n: int, rank: int, world_size: int) -> slice:
    """The contiguous rows of an ``n``-row axis that ``P("data")`` gives
    device ``rank`` of ``world_size``; ``n`` must divide evenly."""
    if n % world_size:
        raise ValueError(f"a batch of {n} rows does not split over a data axis of {world_size}")
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)


# --------------------------------------------------------------------- FSDP rule

def flax_axis_order(ndim: int) -> tuple:
    """The port's axes in the order of the flax layout's: conv kernels are
    OIHW here and HWIO in flax, dense weights (out, in) here and (in, out)
    there (``utils/convert.py``)."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def fsdp_sharding_for(shape, world_size: int, min_size: int = 2**14) -> Optional[int]:
    """The axis of a parameter of the port's ``shape`` to shard over a data
    axis of ``world_size``, or None to keep it whole: the JAX rule (the
    largest axis divisible by the data size; params under ``min_size``
    elements or with no such axis stay replicated), with ties broken in the
    flax layout's order so the same tensor axis is chosen."""
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) < min_size:
        return None
    order = flax_axis_order(len(shape))
    for axis in sorted(order, key=lambda i: -shape[i]):  # stable: ties keep the flax order
        if shape[axis] % world_size == 0:
            return axis
    return None


# ---------------------------------------------------------------------- gathers

def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP parameter (a view), or ``t`` itself."""
    return t.to_local() if is_sharded(t) else t


def gather_to_host(tree, keep: bool = True):
    """Nested dicts of tensors as whole CPU tensors. A sharded tensor is
    gathered with ``full_tensor()``, a collective every rank must enter in the
    same order; with ``keep=False`` (the ranks that write nothing) the gathered
    values are dropped and None stands in their place."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v, keep) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        full = tree.detach().full_tensor() if is_sharded(tree) else tree.detach()
        return full.to("cpu", copy=True) if keep else None
    return tree
