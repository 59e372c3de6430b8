import json
import os

from .common import Schedule, SchedulerConfig, leading_timesteps, make_betas  # noqa: F401
from .ddim import DDIMScheduler  # noqa: F401
from .ddpm import DDPMScheduler  # noqa: F401


def scheduler_from_config(config: dict):
    """Instantiate a scheduler from a serialized config dict, honoring the
    ``_class_name`` written by both packages and by diffusers."""
    name = config.get("_class_name", "DDPMScheduler")
    if "DDIM" in name:
        return DDIMScheduler.from_config(config)
    return DDPMScheduler.from_config(config)


def save_scheduler(scheduler, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    cfg = scheduler.config.config_dict()
    cfg["_class_name"] = type(scheduler).__name__
    with open(os.path.join(directory, "scheduler_config.json"), "w") as fh:
        json.dump(cfg, fh, indent=2, sort_keys=True)


def load_scheduler(directory: str):
    with open(os.path.join(directory, "scheduler_config.json")) as fh:
        return scheduler_from_config(json.load(fh))
