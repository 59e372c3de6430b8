"""The files a cell is made of that hold code, found by name: a traffic mix's mode
(``benchmark/modes/<mode>.py``), an open loop's arrival process (``benchmark/arrivals/<arrivals>.py``) and a
per-layer metric's reader (``benchmark/layer_metrics/<metric>.py``). A cell of a new kind adds such a file
beside the others and edits none of them."""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

BASE = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, executed once per process."""
    if not NAME.match(name):
        raise ValueError(f"{kind}: {name!r} is not a name")
    key = f"benchmark_{kind}__{name.encode().hex()}"  # one module per file, whatever its name
    if key not in sys.modules:
        path = BASE / kind / f"{name}.py"
        if not path.exists():
            raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]
