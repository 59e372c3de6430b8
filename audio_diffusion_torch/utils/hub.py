"""Hugging Face Hub ids, resolved from the local cache only (port of
``audio_diffusion_tpu/utils/hub.py``).

``resolve_pretrained`` turns a ``from_pretrained`` argument into a local
directory: a directory passes through, and a Hub id like
``teticio/audio-diffusion-256`` resolves to the snapshot that the local HF
cache already holds. The cache is read by hand, in the layout that
``huggingface_hub`` writes, so the port needs neither that package nor a
network: ``<cache>/models--{namespace}--{name}/refs/main`` names the commit
whose files are in ``snapshots/<commit>/``. An id that is not cached raises
one actionable ``FileNotFoundError``; nothing is downloaded.

``ensure_repo`` and ``push_folder`` (the trainer's push to the Hub) raise:
the port has no network path.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Optional

logger = logging.getLogger("audio_diffusion_torch.hub")

# "namespace/name" — the Hub's repo id shape. Anchored single slash so
# relative paths like "models/run3" (which also contain one slash) are only
# treated as ids when they do NOT exist locally (checked first by callers).
_MODEL_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-]*/[A-Za-z0-9._\-]+$")


def looks_like_model_id(name: str) -> bool:
    return bool(_MODEL_ID_RE.match(name))


def hub_cache_dir() -> str:
    """``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.path.expanduser(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return os.path.join(os.path.expanduser(os.environ["HF_HOME"]), "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def cached_snapshot(model_id: str) -> Optional[str]:
    """The cached snapshot directory of ``model_id`` at ``refs/main``, or None."""
    repo = os.path.join(hub_cache_dir(), "models--" + model_id.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as fh:
            commit = fh.read().strip()
    except OSError:
        return None
    snapshot = os.path.join(repo, "snapshots", commit)
    return snapshot if commit and os.path.isdir(snapshot) else None


def resolve_pretrained(path_or_id: str) -> str:
    """Resolve a ``from_pretrained`` argument to a local directory.

    Local directories pass through untouched. Hub model ids resolve from the
    local HF cache. Anything else, and ids that are not cached, raise
    ``FileNotFoundError`` with the fix spelled out.
    """
    if os.path.isdir(path_or_id):
        return path_or_id
    if not looks_like_model_id(path_or_id):
        raise FileNotFoundError(
            f"{path_or_id!r} is neither a local directory nor a Hub model id "
            "(expected 'namespace/name', e.g. 'teticio/audio-diffusion-256'). "
            "Pass the path of a saved pipeline directory or a Hub id."
        )
    local = cached_snapshot(path_or_id)
    if local is None:
        raise FileNotFoundError(
            f"Hub model id {path_or_id!r} is not in the local HF cache ({hub_cache_dir()}), and this "
            "package does not download. Download the repository on a connected machine "
            f"(`huggingface-cli download {path_or_id}`), then copy its cache here (set HF_HUB_CACHE or "
            "HF_HOME to it) or pass the downloaded directory's local path instead."
        )
    logger.info("resolved %s from the local HF cache: %s", path_or_id, local)
    return local


def ensure_repo(repo_id: Optional[str], output_dir: str, token: Optional[str] = None, private: bool = False) -> str:
    """Raises: creating a Hub repository needs the network, which the port does not use."""
    raise RuntimeError(
        f"push_to_hub: the Hub repo {repo_id or output_dir!r} cannot be created, as this package has no network "
        "path. Drop --push_to_hub and upload the saved output_dir later from a connected machine "
        "(`huggingface-cli upload`).")


def push_folder(directory: str, repo_id: str, token: Optional[str] = None, message: Optional[str] = None) -> None:
    """Raises, as :func:`ensure_repo` does."""
    raise RuntimeError(
        f"push_to_hub: {directory!r} cannot be uploaded to {repo_id!r}, as this package has no network path. "
        "Upload it later from a connected machine (`huggingface-cli upload`).")
