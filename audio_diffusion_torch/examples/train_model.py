"""End to end: build a dataset from audio, train a few epochs, generate
(reference: notebooks/train_model.ipynb; port of ``examples/train_model.py``).

Run: python -m audio_diffusion_torch.examples.train_model path-to-audio-dir out-dir [--device cpu]

The optional flags keep the notebook-scale defaults but let a smoke test run
the same path on a tiny model: --epochs/--resolution/--hop shrink the run;
--from_pretrained starts from a saved (small) pipeline instead of the
reference architecture. Building the dataset needs the ``datasets`` and
``pandas`` packages.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("audio_dir")
    p.add_argument("out_dir")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--hop", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50, help="generation steps at the end")
    p.add_argument("--from_pretrained", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..data.prepare import audio_to_images
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..training.loop import RunConfig, run_training
    from ..training.train_unet import TrainConfig

    audio_to_images(a.audio_dir, f"{a.out_dir}/data", resolution=(a.resolution, a.resolution), hop_length=a.hop,
                    device=a.device)
    result = run_training(
        RunConfig(dataset=f"{a.out_dir}/data", output_dir=f"{a.out_dir}/model",
                  num_epochs=a.epochs, train_batch_size=2, eval_batch_size=2,
                  hop_length=a.hop, save_model_epochs=min(5, a.epochs),
                  save_images_epochs=min(5, a.epochs),
                  from_pretrained=a.from_pretrained, device=a.device),
        TrainConfig(lr_warmup_steps=50),
    )
    print({k: v for k, v in result.items() if k != "losses"})

    pipe = AudioDiffusionPipeline.from_pretrained(f"{a.out_dir}/model", device=a.device)
    out = pipe(batch_size=1, steps=a.steps, generator=torch.Generator(device=pipe.device).manual_seed(42))
    out.images[0].save(f"{a.out_dir}/sample.png")
    print("wrote", f"{a.out_dir}/sample.png")


if __name__ == "__main__":
    main()
