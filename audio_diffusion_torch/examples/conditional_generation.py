"""Conditional generation from AudioEncoder embeddings (reference:
notebooks/conditional_generation.ipynb, audio_encoder.ipynb; port of
``examples/conditional_generation.py``).

Run: python -m audio_diffusion_torch.examples.conditional_generation model-dir some.wav [--device cpu]
(the model directory in either layout)
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_dir")
    p.add_argument("audio_file")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..models.audio_encoder import AudioEncoder
    from ..ops.audio_io import normalize, write_wav
    from ..pipelines.pipeline import AudioDiffusionPipeline

    pipe = AudioDiffusionPipeline.from_pretrained(a.model_dir, device=a.device)
    # or AudioEncoder.from_pretrained(dir) for trained weights (.bin or .safetensors)
    encoder = AudioEncoder().init_params(torch.Generator().manual_seed(0)).to(pipe.device).eval()
    encoding = encoder.encode([a.audio_file], pool="average")  # (1, 100)

    out = pipe(batch_size=1, encoding=encoding[:, None, :],
               generator=torch.Generator(device=pipe.device).manual_seed(0))
    write_wav("conditional.wav", normalize(out.audios[0]), out.sample_rate)
    print("wrote conditional.wav")


if __name__ == "__main__":
    main()
