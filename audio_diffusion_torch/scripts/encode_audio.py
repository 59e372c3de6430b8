"""Pickle AudioEncoder embeddings for each unique audio file in a dataset
(port of ``scripts/encode_audio.py``; reference: scripts/encode_audio.py).

    python -m audio_diffusion_torch.scripts.encode_audio --dataset DATA --output_file encodings.p \\
        [--pretrained_encoder ENCODER_DIR]

Without ``--pretrained_encoder`` the encoder has seeded random weights, as in
the JAX script. Needs the ``datasets`` package to read the dataset.
"""

import argparse
import logging

from ..data.prepare import encode_audio_dataset


def main(argv=None):
    logging.basicConfig(level=logging.WARN)
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default="data/audio-encodings")
    p.add_argument("--output_file", type=str, default="data/encodings.p")
    p.add_argument("--pretrained_encoder", type=str, default=None,
                   help="directory with an AudioEncoder config.json + diffusion_pytorch_model.bin (optional)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    encoder = None
    if a.pretrained_encoder:
        from ..models.audio_encoder import AudioEncoder

        encoder = AudioEncoder.from_pretrained(a.pretrained_encoder, device=a.device)
    return encode_audio_dataset(a.dataset, a.output_file, encoder, device=a.device)


if __name__ == "__main__":
    main()
