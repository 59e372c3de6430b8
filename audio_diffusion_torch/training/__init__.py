"""Training on one device: the UNet trainer (``train_unet``, ``loop``,
``checkpoint``, run as ``python -m audio_diffusion_torch.training``) and the
adversarial VAE trainer (``train_vae``, ``perceptual``)."""

from ..models.ema import EMA  # noqa: F401
from .checkpoint import CheckpointManager, make_manager, restore_train_state, save_train_state  # noqa: F401
from .loop import RunConfig, run_training  # noqa: F401
from .train_unet import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
