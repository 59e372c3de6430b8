from .audio_encoder import AudioEncoder, AudioEncoderConfig  # noqa: F401
from .unet2d import UNet2D, UNetConfig, conditional_config, unconditional_config  # noqa: F401
from .vae import AutoencoderKL, VAEConfig  # noqa: F401
