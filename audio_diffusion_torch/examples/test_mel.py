"""Mel round trip (reference: notebooks/test_mel.ipynb; port of ``examples/test_mel.py``).

Audio -> 256x256 mel image -> Griffin-Lim audio, plus the batched API.
Run: python -m audio_diffusion_torch.examples.test_mel [audio.wav] [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("audio", nargs="?", default=None, help="an audio file (default: a synthetic chord)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)

    from ..mel import Mel
    from ..ops.audio_io import load_audio, normalize, write_wav

    mel = Mel(device=a.device)  # x_res=256, y_res=256, sr=22050, hop=512: the reference's defaults
    if a.audio is not None:
        audio = load_audio(a.audio, mel.get_sample_rate())
    else:  # synthetic chord
        t = np.arange(3 * mel.slice_size) / mel.get_sample_rate()
        audio = sum(amp * np.sin(2 * np.pi * f * t) for f, amp in [(220, .5), (330, .3), (440, .2)])
        audio = (audio / np.abs(audio).max() * 0.8).astype(np.float32)

    mel.load_audio(raw_audio=audio)
    print(f"{mel.get_number_of_slices()} slices of {mel.slice_size} samples "
          f"(~{mel.slice_size / mel.get_sample_rate():.2f}s each)")

    image = mel.audio_slice_to_image(0)
    image.save("slice0.png")
    print("wrote slice0.png", image.size)

    reconstructed = mel.image_to_audio(image)
    write_wav("slice0_roundtrip.wav", normalize(reconstructed), mel.get_sample_rate())
    print("wrote slice0_roundtrip.wav", reconstructed.shape)

    # Batched API: all slices at once on the device.
    batch = np.stack([mel.get_audio_slice(i) for i in range(mel.get_number_of_slices())])
    images = mel.spectrogram_images_from_audio(batch)
    audios = mel.images_to_audio(images)
    print("batched:", tuple(images.shape), "->", tuple(audios.shape))


if __name__ == "__main__":
    main()
