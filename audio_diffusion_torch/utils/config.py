"""Dataclass-based configuration with diffusers-compatible JSON serialization.

The reference serializes every component's hyperparameters as a JSON sidecar via
diffusers ``ConfigMixin``/``register_to_config`` (reference: audiodiffusion/mel.py:56-58).
We replicate the on-disk contract (``{config_name}`` JSON with ``_class_name`` /
``_version`` keys) with a plain-dataclass mixin so checkpoints saved by the
reference stack can be read back, without depending on diffusers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Type, TypeVar

VERSION = "0.1.0"

T = TypeVar("T", bound="ConfigMixin")


class ConfigMixin:
    """Mixin for frozen dataclasses providing save_config / from_config / from_pretrained.

    Subclasses must be dataclasses and set ``config_name`` (the JSON filename).
    Unknown keys in a loaded config (e.g. diffusers-private ``_diffusers_version``)
    are ignored, so diffusers-written ``mel_config.json`` files load unchanged.
    """

    config_name: str = "config.json"

    def config_dict(self) -> Dict[str, Any]:
        out = {"_class_name": type(self).__name__, "_version": VERSION}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    def save_config(self, save_directory: str) -> str:
        os.makedirs(save_directory, exist_ok=True)
        path = os.path.join(save_directory, self.config_name)
        with open(path, "w") as fh:
            json.dump(self.config_dict(), fh, indent=2, sort_keys=True)
        return path

    @classmethod
    def from_config(cls: Type[T], config: Dict[str, Any], **overrides: Any) -> T:
        field_names = {f.name for f in dataclasses.fields(cls)}  # type: ignore[arg-type]
        kwargs = {}
        for f in dataclasses.fields(cls):  # type: ignore[arg-type]
            if f.name in config:
                v = config[f.name]
                if isinstance(v, list):
                    # JSON has no tuples; restore tuples for hashability/staticness.
                    v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                kwargs[f.name] = v
        kwargs.update({k: v for k, v in overrides.items() if k in field_names})
        return cls(**kwargs)  # type: ignore[call-arg]

    @classmethod
    def load_config(cls, directory: str) -> Dict[str, Any]:
        path = os.path.join(directory, cls.config_name)
        with open(path) as fh:
            return json.load(fh)

    @classmethod
    def from_pretrained(cls: Type[T], directory: str, **overrides: Any) -> T:
        return cls.from_config(cls.load_config(directory), **overrides)
