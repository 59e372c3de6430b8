"""Generate a deterministic synthetic-but-musical WAV corpus (a copy of
``scripts/make_audio.py``: the same seed gives the same WAV bytes).

    python -m audio_diffusion_torch.scripts.make_audio --output_dir DIR [--files 24] [--seed 42]

Each file holds a few bars of chord arpeggios (3-4 harmonics, exponential
decays) over percussion-like noise bursts with a slow amplitude LFO, so
spectrograms carry harmonic rows, onset columns and envelopes (non-trivial
structure for a VAE/UNet) while being fully reproducible with zero external
data (the reference trains on user-supplied audio, reference: README.md:84-102).
numpy and the standard library only.
"""

import argparse
import os
import wave

import numpy as np

SR = 22050


def synth_file(path: str, rng: np.random.Generator, n_samples: int) -> None:
    t = np.arange(n_samples) / SR
    audio = np.zeros(n_samples, dtype=np.float64)

    # minor-pentatonic-ish frequency pool
    base_freqs = 110.0 * 2 ** (np.array([0, 3, 5, 7, 10, 12, 15, 17]) / 12.0)

    # arpeggio: a note every ~0.18 s with exponential decay, 4 harmonics
    note_len = int(0.18 * SR)
    for k in range(n_samples // note_len):
        f = base_freqs[rng.integers(len(base_freqs))] * (2 ** rng.integers(0, 3))
        s = k * note_len
        e = min(n_samples, s + int(0.5 * SR))
        tt = np.arange(e - s) / SR
        env = np.exp(-tt * rng.uniform(3.0, 8.0))
        for h, amp in ((1, 1.0), (2, 0.5), (3, 0.25), (4, 0.12)):
            audio[s:e] += amp * env * np.sin(2 * np.pi * f * h * tt + rng.uniform(0, 6.28))

    # percussion: noise bursts every ~0.36 s
    hit_len = int(0.05 * SR)
    for s in range(0, n_samples - hit_len, int(0.36 * SR)):
        burst = rng.normal(0, 1, hit_len) * np.exp(-np.arange(hit_len) / (0.01 * SR))
        audio[s:s + hit_len] += 0.6 * burst

    audio *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t + rng.uniform(0, 6.28))
    audio /= np.abs(audio).max() + 1e-9
    pcm = (audio * 32000).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--files", type=int, default=24)
    p.add_argument("--slices", type=int, default=2, help="256x256 slices per file")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    a = p.parse_args(argv)

    os.makedirs(a.output_dir, exist_ok=True)
    rng = np.random.default_rng(a.seed)
    slice_len = a.resolution * a.hop_length - 1  # matches Mel slicing (mel.py:90)
    for i in range(a.files):
        synth_file(os.path.join(a.output_dir, f"clip_{i:03d}.wav"), rng,
                   slice_len * a.slices + 1024)
    print(f"wrote {a.files} files ({a.slices} slices each) to {a.output_dir}")


if __name__ == "__main__":
    main()
