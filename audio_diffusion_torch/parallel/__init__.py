"""Data parallelism over ``torch.distributed`` and the inference mesh (port of ``audio_diffusion_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_slice,
    fsdp_sharding_for,
    gather_to_host,
    init_distributed,
    is_main_process,
    make_mesh,
    rank_device,
    world,
)
