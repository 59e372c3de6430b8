from .common import Schedule, SchedulerConfig, leading_timesteps, make_betas  # noqa: F401
from .ddim import DDIMScheduler  # noqa: F401
