from .unet2d import UNet2D, UNetConfig, unconditional_config  # noqa: F401
from .vae import AutoencoderKL, VAEConfig  # noqa: F401
