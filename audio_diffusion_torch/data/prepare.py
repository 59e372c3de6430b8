"""Dataset preparation: audio directory -> spectrogram-image dataset, and
AudioEncoder encodings of a dataset's files (port of
``audio_diffusion_tpu/data/prepare.py``).

All slices of a file go through one batched ``Mel.spectrogram_images_from_audio``
on the Mel's device; decoding stays on the host (``ops/audio_io.py``).
Behavioural parity with the reference (scripts/audio_to_images.py:17-80):
walks for .mp3/.wav/.m4a, per-file errors are caught and skipped, fully
silent slices (all pixels 255: a silent spectrogram quantizes to 255
because ref=max floors at its own amin) are skipped, and the features are
{image: PNG, audio_file: str, slice: int16}.

Writing and reading the HF dataset needs the ``datasets`` package (and
pandas), as in the JAX package; without them those two functions raise an
``ImportError`` that names the package. :func:`write_png_dataset` and
:func:`encode_slices` need neither: they write the same slices as a folder of
PNGs, which both packages' ``ImageSliceDataset`` read in the HF dataset's
order, and its encodings.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..mel import Mel

logger = logging.getLogger("audio_diffusion_torch.data")

AUDIO_RE = re.compile(r"\.(mp3|wav|m4a)$", re.IGNORECASE)
SLICE_DIGITS = 5  # a slice index is an int16 feature of the HF dataset: at most 5 digits


def _import_datasets():
    try:
        import datasets
        import pandas
    except ImportError as e:
        raise ImportError(
            "writing and reading a HF image dataset needs the `datasets` and `pandas` packages, which are not "
            f"installed ({e}). Install them, or use find_audio_files/file_to_examples directly.") from e
    return datasets, pandas


def find_audio_files(input_dir: str) -> List[str]:
    files = [
        os.path.join(root, f)
        for root, _, files in os.walk(input_dir)
        for f in sorted(files)
        if AUDIO_RE.search(f)
    ]
    compressed = [f for f in files if not f.lower().endswith(".wav")]
    if compressed:
        import shutil

        from . import native_audio

        if not native_audio.media_available() and not shutil.which("ffmpeg"):
            logger.warning(
                "%d mp3/m4a file(s) found but NO decoder is available (the native "
                "media decoder needs the system libavformat/libavcodec, and no "
                "ffmpeg binary was found) — these files will be SKIPPED. First: %s",
                len(compressed), compressed[0],
            )
    return files


def file_to_examples(mel: Mel, audio_file: str) -> List[dict]:
    """All non-silent slices of one file as dataset examples (one batched mel forward)."""
    mel.load_audio(audio_file)
    n = mel.get_number_of_slices()
    if n == 0:
        return []
    batch = np.stack([mel.get_audio_slice(i) for i in range(n)])
    images = mel.spectrogram_images_from_audio(batch).cpu().numpy()  # (n, y, x) uint8
    examples = []
    for i in range(n):
        img = images[i]
        if img.shape != (mel.y_res, mel.x_res):
            raise ValueError(f"wrong resolution {img.shape}, expected {(mel.y_res, mel.x_res)}")
        if (img == 255).all():  # completely silent slice
            logger.warning("File %s slice %d is completely silent", audio_file, i)
            continue
        with io.BytesIO() as buf:
            Image.fromarray(img).save(buf, format="PNG")
            png = buf.getvalue()
        examples.append({"image": {"bytes": png, "path": None}, "audio_file": audio_file, "slice": i})
    return examples


def audio_to_images(
    input_dir: str,
    output_dir: str,
    resolution: Tuple[int, int] = (256, 256),
    hop_length: int = 512,
    sample_rate: int = 22050,
    n_fft: int = 2048,
    push_to_hub: Optional[str] = None,
    device: torch.device | str = "cuda",
):
    """Build and save a HF image dataset from a directory of audio files, the
    mel forward on ``device``. ``push_to_hub`` raises: the port has no
    network path."""
    if push_to_hub:
        raise RuntimeError(f"push_to_hub={push_to_hub!r}: this package has no network path; upload {output_dir!r} "
                           "later from a connected machine")
    datasets, pd = _import_datasets()
    mel = Mel(x_res=resolution[0], y_res=resolution[1], hop_length=hop_length, sample_rate=sample_rate, n_fft=n_fft,
              device=device)
    os.makedirs(output_dir, exist_ok=True)
    examples = []
    for f in find_audio_files(input_dir):
        try:
            examples.extend(file_to_examples(mel, f))
        except KeyboardInterrupt:
            raise
        except Exception as e:  # skip undecodable files, like the reference
            logger.warning("skipping %s: %s", f, e)
    if not examples:
        logger.warning("No valid audio files were found.")
        return None
    ds = datasets.Dataset.from_pandas(
        pd.DataFrame(examples),
        features=datasets.Features({
            "image": datasets.Image(),
            "audio_file": datasets.Value(dtype="string"),
            "slice": datasets.Value(dtype="int16"),
        }),
    )
    dsd = datasets.DatasetDict({"train": ds})
    dsd.save_to_disk(output_dir)
    return dsd


def write_png_dataset(mel: Mel, input_dir: str, output_dir: str) -> Dict[str, str]:
    """Write the slices :func:`audio_to_images` keeps as a folder of PNGs,
    ``<output_dir>/<file stem>_<slice, zero-padded>.png``, and return {png
    path: audio file} in the HF dataset's order (the files as
    :func:`find_audio_files` lists them, then their slices). The names sort
    into that order, which a folder reader takes, so a trainer's epochs and a
    dataset's last slices are the HF dataset's; a file stem that would sort
    otherwise, or two files of one stem, raise. Needs neither ``datasets``
    nor pandas."""
    os.makedirs(output_dir, exist_ok=True)
    slices: Dict[str, str] = {}
    for f in find_audio_files(input_dir):
        try:
            examples = file_to_examples(mel, f)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # skip undecodable files, like the reference
            logger.warning("skipping %s: %s", f, e)
            continue
        stem = os.path.splitext(os.path.basename(f))[0]
        for ex in examples:
            path = os.path.join(output_dir, f"{stem}_{ex['slice']:0{SLICE_DIGITS}d}.png")
            if path in slices:
                raise ValueError(f"{slices[path]!r} and {f!r} both write {path!r}")
            with open(path, "wb") as fh:
                fh.write(ex["image"]["bytes"])
            slices[path] = f
    if list(slices) != sorted(slices):
        raise ValueError(f"the file names under {input_dir!r} do not sort as their slices' PNG names; rename them")
    if not slices:
        logger.warning("No valid audio files were found.")
    return slices


def _encoder(encoder, device):
    """``encoder`` on ``device``, or a seeded random one, ``AudioEncoder().init_params(seed 0)``,
    as the JAX function inits one from ``key(0)``."""
    from ..models.audio_encoder import AudioEncoder

    if encoder is None:
        encoder = AudioEncoder().init_params(torch.Generator().manual_seed(0))
    return encoder.to(device).eval()


def _encode_files(encoder, files: Sequence[str]) -> dict:
    """{audio file: its encoding}; a file that fails is skipped with a warning."""
    encodings = {}
    for f in files:
        try:
            encodings[f] = encoder.encode([f])[0].cpu().numpy()
        except Exception as e:
            logger.warning("skipping %s: %s", f, e)
    return encodings


def _check_device(device, what: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA device requested but torch.cuda is not available; "
                           "pass device='cpu' to run on the CPU")


def _pickle(obj, output_file: str) -> None:
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "wb") as fh:
        pickle.dump(obj, fh)


def encode_slices(slice_files: Dict[str, str], output_file: str, encoder=None,
                  device: torch.device | str = "cuda") -> dict:
    """Pickle {png path: AudioEncoder embedding of its audio file} for the
    folder :func:`write_png_dataset` wrote (``slice_files`` is what it
    returned), in its order: a trainer looks a folder item's encoding up by
    its path. Each audio file is encoded once; ``encoder`` as in
    :func:`encode_audio_dataset`. Needs neither ``datasets`` nor pandas."""
    _check_device(device, "encode_slices")
    per_file = _encode_files(_encoder(encoder, device), sorted(set(slice_files.values())))
    encodings = {png: per_file[f] for png, f in slice_files.items() if f in per_file}
    _pickle(encodings, output_file)
    return encodings


def encode_audio_dataset(dataset_path: str, output_file: str, encoder=None,
                         device: torch.device | str = "cuda") -> dict:
    """Compute AudioEncoder embeddings for each unique audio_file in a dataset
    and pickle {audio_file: encoding} (reference: scripts/encode_audio.py:11-31).
    ``encoder``: an :class:`AudioEncoder` (moved to ``device``), or None for a
    seeded random one, ``AudioEncoder().init_params(seed 0)``, as the JAX
    function inits one from ``key(0)``."""
    _check_device(device, "encode_audio_dataset")
    datasets, _ = _import_datasets()
    encoder = _encoder(encoder, device)
    ds = datasets.load_from_disk(dataset_path)
    if isinstance(ds, datasets.DatasetDict):
        ds = ds["train"]
    encodings = _encode_files(encoder, sorted(set(ds["audio_file"])))
    _pickle(encodings, output_file)
    return encodings
