"""Build a spectrogram-image dataset from a directory of audio files
(port of ``scripts/audio_to_images.py``; reference: scripts/audio_to_images.py),
the mel forward batched on the device.

    python -m audio_diffusion_torch.scripts.audio_to_images --input_dir AUDIO --output_dir DATA

Needs the ``datasets`` and ``pandas`` packages to write the dataset.
"""

import argparse
import logging

from ..data.prepare import audio_to_images


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="data")
    p.add_argument("--resolution", type=str, default="256",
                   help="either one integer N (NxN) or W,H (reference: audio_to_images.py:102-112)")
    p.add_argument("--hop_length", type=int, default=512)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--n_fft", type=int, default=2048)
    p.add_argument("--push_to_hub", type=str, default=None, help="not supported: the port has no network path")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    try:
        parts = [int(x) for x in args.resolution.split(",")]
        if len(parts) == 1:
            args.resolution = (parts[0], parts[0])
        elif len(parts) == 2:
            args.resolution = tuple(parts)
        else:
            raise ValueError
    except ValueError:
        p.error("Resolution must be one integer or two comma-separated integers")
    return args


def main(argv=None):
    logging.basicConfig(level=logging.WARN)
    a = parse_args(argv)
    return audio_to_images(a.input_dir, a.output_dir, a.resolution, a.hop_length, a.sample_rate, a.n_fft,
                           a.push_to_hub, device=a.device)


if __name__ == "__main__":
    main()
