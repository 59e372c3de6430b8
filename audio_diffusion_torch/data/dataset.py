"""Spectrogram-image dataset loading and batching for training (a copy of
``audio_diffusion_tpu/data/dataset.py``: numpy and PIL only, no framework).

The batch order for a (seed, epoch) is the JAX package's, element for element.

The reference trains from a HF ``datasets`` arrow dataset with features
{image: PNG, audio_file: str, slice: int16} built by audio_to_images.py
(reference: scripts/audio_to_images.py:67-78, train_unet.py:52-91). This module
reads that exact format (``datasets.load_from_disk``) or a plain folder of
PNGs, normalizes images to [-1, 1] like the reference's ToTensor+Normalize
transform (train_unet.py:73-78), attaches per-file conditioning encodings
(train_unet.py:85-87), and groups batches as (accum, micro_batch, H, W, C)
for the scanned gradient-accumulation train step.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image


class ImageSliceDataset:
    """Uniform view over a HF on-disk dataset or a folder of PNG spectrograms."""

    def __init__(self, path: str):
        self.path = path
        self._hf = None
        self._files: List[str] = []
        if os.path.isdir(path) and (
            os.path.exists(os.path.join(path, "dataset_dict.json"))
            or os.path.exists(os.path.join(path, "dataset_info.json"))
            or os.path.exists(os.path.join(path, "state.json"))
        ):
            try:
                import datasets
            except ImportError as e:
                raise ImportError(
                    f"{path!r} is a HF datasets directory and reading it needs the `datasets` package, which is "
                    "not installed. Install it, or export the slices as a folder of PNGs.") from e

            ds = datasets.load_from_disk(path)
            if isinstance(ds, datasets.DatasetDict):
                ds = ds["train"]
            self._hf = ds
        elif os.path.isdir(path):
            self._files = sorted(
                os.path.join(root, f)
                for root, _, files in os.walk(path)
                for f in files
                if f.lower().endswith(".png")
            )
            if not self._files:
                raise ValueError(f"No PNG images or HF dataset found under {path!r}")
        else:
            raise ValueError(f"{path!r} is not a directory")

    def __len__(self) -> int:
        return len(self._hf) if self._hf is not None else len(self._files)

    def get(self, index: int) -> Dict:
        if self._hf is not None:
            item = self._hf[int(index)]
            img = item["image"]
            if not isinstance(img, Image.Image):
                img = Image.open(img["path"]) if isinstance(img, dict) else Image.fromarray(np.asarray(img))
            return {
                "image": np.asarray(img.convert("L"), dtype=np.uint8),
                "audio_file": item.get("audio_file", ""),
                "slice": item.get("slice", 0),
            }
        f = self._files[index]
        return {"image": np.asarray(Image.open(f).convert("L"), dtype=np.uint8), "audio_file": f, "slice": 0}

    @property
    def resolution(self) -> Tuple[int, int]:
        """(height, width) — shapes derive from the data, not flags
        (reference: train_unet.py:70-71)."""
        img = self.get(0)["image"]
        return img.shape[0], img.shape[1]


def prefetch(iterator: Iterator, size: int = 2,
             transform: Optional[Callable[[Any], Any]] = None) -> Iterator:
    """Run ``iterator`` (and ``transform`` on each item) in a background
    thread, keeping up to ``size`` results staged ahead of the consumer.

    Used by the training loops to take PNG decode + normalization + the
    host-to-device copy off the step critical path: the next batch is
    decoded and already on the device while the current step executes. (The
    reference gets this from torch DataLoader workers, train_unet.py:88-91;
    here one thread does it.)
    Exceptions in the worker re-raise at the consumer's next pull. The
    worker thread is a daemon, so abandoning the iterator mid-epoch (e.g.
    max_steps early-stop) cannot hang interpreter exit.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    sentinel = object()
    stop = threading.Event()
    errors: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(transform(item) if transform is not None else item):
                    return  # consumer left early
        except BaseException as e:  # surfaced to the consumer below
            errors.append(e)
        finally:
            _put(sentinel)

    thread = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:
        stop.set()  # early exit (max_steps): unblock and retire the worker
        thread.join(timeout=5.0)
    if errors:
        raise errors[0]


def load_encodings(path: str) -> Dict[str, np.ndarray]:
    """Pickled {audio_file: encoding} map (reference: train_unet.py:93-94)."""
    with open(path, "rb") as fh:
        enc = pickle.load(fh)
    return {k: np.asarray(v, dtype=np.float32) for k, v in enc.items()}


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8 spectrogram -> [-1, 1] float32, the reference's ToTensor +
    Normalize(0.5, 0.5) (train_unet.py:73-78). One definition: the cached-
    latent path's bit-parity with re-encoding depends on both using it."""
    return np.asarray(image, np.float32) / 255.0 * 2.0 - 1.0


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """Per-epoch shuffle generator derived from (seed, epoch) — the fold_in
    pattern. Any epoch's data order is reconstructible at resume without
    replaying the prior epochs' draws, so a resumed run reproduces the exact
    stream a straight run would have seen (the reference's resume replays
    optimizer steps but restarts the data order, train_unet.py:216-224)."""
    return np.random.default_rng(np.random.SeedSequence((int(seed), int(epoch))))


def epoch_batches(
    dataset: ImageSliceDataset,
    batch_size: int,
    accum: int = 1,
    rng: Optional[np.random.Generator] = None,
    encodings: Optional[Dict[str, np.ndarray]] = None,
    drop_last: bool = True,
    precomputed: Optional[Tuple[np.ndarray, List[str]]] = None,
    start_group: int = 0,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Yield (images, encodings) with images (accum, batch, H, W, 1) in [-1, 1].

    ``batch_size`` is the per-optimizer-step microbatch; ``accum``
    microbatches are grouped per yield.

    ``precomputed`` = (array (N, ...), audio_files) substitutes a cached
    per-item array — e.g. VAE latent moments — for the PIL decode and the
    [-1, 1] image normalization; the array is indexed and grouped as-is.

    ``start_group`` skips the first groups of the (shuffled) epoch — mid-epoch
    resume: the shuffle is computed identically (same ``rng``), then iteration
    continues from the first optimizer step not yet taken.
    """
    n = len(dataset) if precomputed is None else len(precomputed[0])
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    group = batch_size * accum
    limit = (n // group) * group if drop_last else n
    for start in range(start_group * group, limit, group):
        idx = order[start : start + group]
        if precomputed is not None:
            arr, files = precomputed
            images = arr[idx].reshape(accum, batch_size, *arr.shape[1:])
            batch_files = [files[i] for i in idx]
        else:
            items = [dataset.get(i) for i in idx]
            images = normalize_image(np.stack([it["image"] for it in items]))
            images = images[..., None].reshape(accum, batch_size, *images.shape[1:], 1)
            batch_files = [it["audio_file"] for it in items]
        enc_batch = None
        if encodings is not None:
            enc = np.stack([encodings[f] for f in batch_files])
            if enc.ndim == 2:
                enc = enc[:, None, :]  # (B, 1, dim) for cross-attention
            enc_batch = enc.reshape(accum, batch_size, *enc.shape[1:])
        yield images, enc_batch
