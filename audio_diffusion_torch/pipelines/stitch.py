"""Long-audio generation: overlap-masked outpainting and remix stitching
(port of ``audio_diffusion_tpu/pipelines/stitch.py``).

The reference does this in notebook loops (notebooks/test_model.ipynb cells
16 and 20); here they are library functions over the pipeline. They run on
the device of the pipeline they are given; only the stitching of the
returned audio is numpy on the host.

Randomness, in the JAX package's terms: ``outpaint`` splits its key once per
window, so here one generator advances across the windows. Serial ``remix``
pins one key, so every window re-noises from the same draws: here the
generator's state is saved once and restored before each window.
``_remix_parallel`` tiles one noise sample over the window batch and hands
the key on for the steps' variance noise: here the sample is drawn once from
the generator, which then serves as ``step_generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _check_overlap(mel, overlap_samples: int, overlap_secs: float) -> None:
    """An overlap that doesn't fit inside one generation window would silently
    produce empty or non-advancing output (negative stride / empty tail
    slices). Fail with the model's actual window length instead."""
    slice_size = mel.x_res * mel.hop_length
    if not 0 <= overlap_samples < slice_size:
        raise ValueError(
            f"overlap_secs={overlap_secs} is {overlap_samples} samples, but this "
            f"model's generation window is only {slice_size} samples "
            f"({slice_size / mel.get_sample_rate():.2f}s at {mel.get_sample_rate()} Hz) "
            "— choose an overlap shorter than one window."
        )


def _generator(pipe, generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a fresh seed-0 one on the pipeline's device (the JAX ``key(0)`` default)."""
    return generator if generator is not None else torch.Generator(device=pipe.device).manual_seed(0)


def outpaint(
    pipe,
    initial_audio: np.ndarray,
    num_windows: int,
    overlap_secs: float = 2.0,
    start_step: int = 0,
    steps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    eta: float = 0.0,
) -> np.ndarray:
    """Extend audio by repeatedly generating continuation windows whose first
    ``overlap_secs`` are frozen to the previous window's tail
    (test_model.ipynb cell 16). One generator advances across the windows."""
    sample_rate = pipe.mel.get_sample_rate()
    overlap_samples = int(overlap_secs * sample_rate)
    _check_overlap(pipe.mel, overlap_samples, overlap_secs)
    generator = _generator(pipe, generator)

    track = np.asarray(initial_audio, dtype=np.float32)
    audio = track
    for _ in range(num_windows):
        _, (_, audios) = pipe(
            batch_size=1,
            raw_audio=audio[-overlap_samples:],
            start_step=start_step,
            steps=steps,
            generator=generator,
            mask_start_secs=overlap_secs,
            eta=eta,
            return_dict=False,
        )
        audio = np.asarray(audios[0])
        track = np.concatenate([track, audio[overlap_samples:]])
    return track


def remix(
    pipe,
    track_audio: np.ndarray,
    start_step: int = 500,
    overlap_secs: float = 2.0,
    steps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    eta: float = 0.0,
    parallel: bool = False,
) -> np.ndarray:
    """Style-transfer a whole track window by window with pinned randomness
    and overlap re-insertion (test_model.ipynb cell 20). Each window is
    re-noised to ``start_step`` and denoised; the previous window's generated
    tail is peak-matched and written over the new window's head before
    generation. Every window starts from the same generator state.

    ``parallel=True`` trades the serial tail re-insertion for one batched
    call over exactly the track's windows: every window re-noises from the
    same initial noise sample (the serial mode's continuity mechanism) and
    overlaps stitch by linear crossfade instead of tail rewriting. With eta>0
    the per-step noise is batch-shaped, i.e. uncorrelated across windows,
    unlike serial, where the pinned state repeats it; use eta=0 (default) for
    maximal cross-window coherence in parallel mode."""
    if parallel:
        return _remix_parallel(pipe, track_audio, start_step, overlap_secs, steps, generator, eta)
    mel = pipe.mel
    sample_rate = mel.get_sample_rate()
    overlap_samples = int(overlap_secs * sample_rate)
    _check_overlap(mel, overlap_samples, overlap_secs)
    slice_size = mel.x_res * mel.hop_length
    stride = slice_size - overlap_samples
    generator = _generator(pipe, generator)
    pinned = generator.get_state()

    track_audio = np.asarray(track_audio, dtype=np.float32)
    track = np.array([], dtype=np.float32)
    prev = None
    for sample in range(len(track_audio) // stride):
        window = np.array(track_audio[sample * stride : sample * stride + slice_size])
        not_first = int(prev is not None)
        if not_first:
            head = window[:overlap_samples]
            tail = prev[-overlap_samples:]
            scale = np.max(np.abs(head)) / max(np.max(np.abs(tail)), 1e-8)
            window[:overlap_samples] = tail * scale
        generator.set_state(pinned)  # the same draws for every window, like the seeded generator
        _, (_, audios) = pipe(
            batch_size=1,
            raw_audio=window,
            start_step=start_step,
            steps=steps,
            generator=generator,
            mask_start_secs=overlap_secs * not_first,
            eta=eta,
            return_dict=False,
        )
        prev = np.asarray(audios[0])
        track = np.concatenate([track, prev[overlap_samples * not_first :]])
    return track


def _remix_parallel(pipe, track_audio, start_step, overlap_secs, steps, generator, eta):
    """All windows in ONE batched generation (see :func:`remix` parallel=True).

    Matches the serial mode's pinned semantics by tiling one shared
    initial-noise sample across the window batch; windows crossfade linearly
    over ``overlap_secs`` at stitch time."""
    mel = pipe.mel
    sample_rate = mel.get_sample_rate()
    overlap_samples = int(overlap_secs * sample_rate)
    _check_overlap(mel, overlap_samples, overlap_secs)
    slice_size = mel.x_res * mel.hop_length
    stride = slice_size - overlap_samples
    generator = _generator(pipe, generator)

    track_audio = np.asarray(track_audio, dtype=np.float32)
    n = len(track_audio) // stride
    if n == 0:
        return np.array([], dtype=np.float32)
    windows = np.stack([
        np.pad(w := track_audio[i * stride : i * stride + slice_size], (0, slice_size - len(w)))
        for i in range(n)
    ])

    h, w_ = pipe.sample_hw
    noise1 = torch.randn((1, h, w_, pipe.unet.config.in_channels), generator=generator, device=generator.device)
    _, audios_dev = pipe(
        raw_audio=windows,
        start_step=start_step,
        steps=steps,
        noise=noise1.repeat(n, 1, 1, 1),
        step_generator=generator,
        eta=eta,
        return_arrays=True,  # only the audio comes to the host, not the spectrograms
    )
    audios = list(audios_dev.cpu().numpy())

    out = audios[0]
    fade_in = np.linspace(0.0, 1.0, overlap_samples, dtype=np.float32) if overlap_samples else None
    for a in audios[1:]:
        if overlap_samples:
            head = out[-overlap_samples:] * (1.0 - fade_in) + a[:overlap_samples] * fade_in
            out = np.concatenate([out[:-overlap_samples], head, a[overlap_samples:]])
        else:
            out = np.concatenate([out, a])
    return out
