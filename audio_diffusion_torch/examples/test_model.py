"""Full inference matrix (reference: notebooks/test_model.ipynb; port of
``examples/test_model.py``): generation + looping, variations via
start_step, outpainting continuation, remix stitching, inpainting, eta=1,
DDIM encode/reconstruct, slerp interpolation.

Run: python -m audio_diffusion_torch.examples.test_model path/to/model [audio.wav] [--device cpu]
(the model directory in either layout, or a Hub id in the local HF cache)
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model")
    p.add_argument("audio", nargs="?", default=None, help="a track to remix")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    import torch

    from ..audio_diffusion import AudioDiffusion
    from ..ops.audio_io import load_audio, normalize, write_wav
    from ..pipelines.pipeline import AudioDiffusionPipeline
    from ..pipelines.stitch import outpaint, remix
    from ..schedulers import DDIMScheduler

    ad = AudioDiffusion(model_id=a.model, device=a.device)
    pipe = ad.pipe
    sr = pipe.mel.get_sample_rate()

    def seed(n):
        return torch.Generator(device=pipe.device).manual_seed(n)

    # The notebook's 2 s overlaps / 1 s masks assume the published models' 5.94 s
    # generation window; scale down proportionally for smaller windows (a tiny
    # test model's window is shorter than 2 s, which stitch refuses).
    window_secs = pipe.mel.x_res * pipe.mel.hop_length / sr
    overlap = min(2.0, round(window_secs / 3, 3))
    mask = min(1.0, round(window_secs / 6, 3))

    # --- generation + loop (cells 10/26) ------------------------------------
    image, (sr, audio) = ad.generate_spectrogram_and_audio(generator=seed(42))
    write_wav("generated.wav", normalize(audio), sr)
    loop = AudioDiffusion.loop_it(audio, sr)
    if loop is not None:
        write_wav("generated_loop.wav", normalize(loop), sr)
    else:
        print("Unable to determine loop points")

    # --- variations via start_step (cells 13-14) -----------------------------
    # The notebook's start_step=500 assumes the 1000-step DDPM schedule;
    # start_step indexes the inference schedule, so take half of this model's
    # default step count (50 for DDIM): half-strength either way.
    half = max(1, pipe.get_default_steps() // 2)
    image2, (_, variation) = ad.generate_spectrogram_and_audio_from_audio(
        raw_audio=audio, start_step=half, generator=seed(1))
    write_wav("variation.wav", normalize(variation), sr)

    # --- outpainting continuation with 2 s overlap (cell 16) ------------------
    track = outpaint(pipe, audio, num_windows=4, overlap_secs=overlap, generator=seed(2))
    write_wav("outpainted.wav", normalize(track), sr)

    # --- remix / style transfer (cell 20) ------------------------------------
    if a.audio is not None:
        source = load_audio(a.audio, sr)
        restyled = remix(pipe, source, start_step=half, overlap_secs=overlap, generator=seed(3))
        write_wav("remixed.wav", normalize(restyled), sr)

    # --- inpainting with both masks (cell 22) --------------------------------
    _, (_, inpainted) = ad.generate_spectrogram_and_audio_from_audio(
        raw_audio=audio, mask_start_secs=mask, mask_end_secs=mask, generator=seed(4))
    write_wav("inpainted.wav", normalize(inpainted), sr)

    # --- DDIM eta (cell 28) ---------------------------------------------------
    _, (_, noisy) = ad.generate_spectrogram_and_audio(eta=1.0, generator=seed(5), step_generator=seed(6))
    write_wav("eta1.wav", normalize(noisy), sr)

    # --- DDIM encode / reconstruct / slerp (cells 32-37) ----------------------
    # Inversion needs a deterministic scheduler. The notebook switches to a
    # -ddim- model here; schedulers share the trained alphas, so for a DDPM
    # model a DDIM scheduler goes over the same pipeline components.
    if not isinstance(pipe.scheduler, DDIMScheduler):
        pipe = AudioDiffusionPipeline(pipe.unet, pipe.mel, DDIMScheduler(pipe.scheduler.config), pipe.vqvae,
                                      device=pipe.device)

    out = pipe(batch_size=2, steps=50, generator=seed(7))
    noise = pipe.encode(out.images)
    rec = pipe(batch_size=1, steps=50, noise=noise[:1], return_images_only=True)
    mae = np.abs(out.raw_images[0].astype(float) - rec[0].astype(float)).mean()
    print(f"DDIM encode->reconstruct image MAE: {mae:.2f}/255")

    interp = AudioDiffusionPipeline.slerp(noise[0], noise[1], 0.5)
    _, (_, mix) = pipe(batch_size=1, noise=interp[None], return_dict=False)
    write_wav("slerp_mix.wav", normalize(mix[0]), sr)
    print("done: wrote generated/variation/outpainted/inpainted/eta1/slerp_mix wavs")


if __name__ == "__main__":
    main()
