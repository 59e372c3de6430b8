"""Port parity of dataset preparation and host I/O on the CPU: four synthetic
WAVs (22.05 kHz mono, 44.1 kHz stereo, one with a silent slice, one shorter
than a slice) through ``find_audio_files`` -> ``file_to_examples`` against
the JAX package (the same slices kept, images within 1 uint8, PNGs that
decode to the images); ``audio_to_images`` writes a dataset that the port's
``ImageSliceDataset`` reads; ``encode_audio_dataset`` with converted
AudioEncoder weights within 1e-4 of max |enc| of the JAX one; the native
decoder copy against the JAX module; Hub ids from a fake HF cache; both data
CLIs in a subprocess."""

import io
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from conftest import synth_audio
from PIL import Image
from test_torch_models import random_params

from audio_diffusion_torch.audio_diffusion import AudioDiffusion
from audio_diffusion_torch.data import native_audio as tnative
from audio_diffusion_torch.data import prepare as tprep
from audio_diffusion_torch.data.dataset import ImageSliceDataset
from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import AudioEncoder as TorchEncoder
from audio_diffusion_torch.ops import audio_io
from audio_diffusion_torch.utils import hub as thub
from audio_diffusion_torch.utils.convert import audio_encoder_state_dict, to_torch
from audio_diffusion_tpu.data import native_audio as jnative
from audio_diffusion_tpu.data import prepare as jprep
from audio_diffusion_tpu.mel import Mel
from audio_diffusion_tpu.models.audio_encoder import AudioEncoder
from audio_diffusion_tpu.ops import audio_io as jax_audio_io
from audio_diffusion_tpu.utils import hub as jhub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, HOP = 64, 512
SLICE = RES * HOP - 1
GOOD = ("a_mono22k.wav", "b_stereo44k.wav", "c_silence.wav", "d_short.wav")


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """The four files of chip_smoke.py's [prepare] at this Mel's slice size, and a junk file."""
    d = tmp_path_factory.mktemp("prep_audio")
    audio_io.write_wav(str(d / GOOD[0]), synth_audio(int(2.3 * SLICE), seed=0), 22050)
    stereo = np.stack([synth_audio(int(4.4 * SLICE), 44100, seed=s) for s in (1, 2)])
    audio_io.write_wav(str(d / GOOD[1]), stereo, 44100)
    silent = np.concatenate([synth_audio(SLICE, seed=3), np.zeros(int(1.5 * SLICE), np.float32)])
    audio_io.write_wav(str(d / GOOD[2]), silent, 22050)
    audio_io.write_wav(str(d / GOOD[3]), synth_audio(int(0.4 * SLICE), seed=4), 22050)
    (d / "e_junk.wav").write_bytes(b"not a wav file")
    return str(d)


@pytest.fixture(scope="module")
def examples(audio_dir):
    files = tprep.find_audio_files(audio_dir)
    assert files == jprep.find_audio_files(audio_dir) and [os.path.basename(f) for f in files[:4]] == list(GOOD)
    tmel, jmel = TorchMel(x_res=RES, y_res=RES, hop_length=HOP, device="cpu"), Mel(x_res=RES, y_res=RES, hop_length=HOP)
    return {f: (tprep.file_to_examples(tmel, f), jprep.file_to_examples(jmel, f)) for f in files[:4]}


def _png(example):
    return np.asarray(Image.open(io.BytesIO(example["image"]["bytes"])))


def test_file_to_examples_matches_jax(examples):
    kept = {}
    for f, (got, want) in examples.items():
        assert [e["slice"] for e in got] == [e["slice"] for e in want]
        kept[os.path.basename(f)] = [e["slice"] for e in got]
        for g, w in zip(got, want):
            assert g["audio_file"] == w["audio_file"] == f and g["image"]["path"] is None
            img = _png(g)
            assert img.shape == (RES, RES) and img.dtype == np.uint8
            assert np.abs(img.astype(int) - _png(w).astype(int)).max() <= 1
    # the silent stretch of c is skipped; the short d is zero-padded to one slice
    assert kept == {GOOD[0]: [0, 1], GOOD[1]: [0, 1], GOOD[2]: [0], GOOD[3]: [0]}


@pytest.fixture(scope="module")
def dataset_dir(audio_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("prep_ds") / "data")
    tprep.audio_to_images(audio_dir, out, resolution=(RES, RES), hop_length=HOP, device="cpu")
    return out


def test_audio_to_images_writes_what_the_trainer_reads(dataset_dir, examples):
    ds = ImageSliceDataset(dataset_dir)
    want = [(f, e["slice"], _png(e)) for f, (got, _) in examples.items() for e in got]
    assert len(ds) == len(want) == 6 and ds.resolution == (RES, RES)
    for i, (f, s, img) in enumerate(want):
        item = ds.get(i)
        assert (item["audio_file"], item["slice"]) == (f, s)
        np.testing.assert_array_equal(item["image"], img)
    with pytest.raises(RuntimeError, match="network"):
        tprep.audio_to_images(dataset_dir, dataset_dir, push_to_hub="user/ds", device="cpu")


@pytest.fixture(scope="module")
def encoders():
    """The full-width AudioEncoder in both packages, the same seeded weights."""
    enc = AudioEncoder()
    rng = np.random.default_rng(51)
    stats = jax.tree_util.tree_map_with_path(  # running mean ~ N(0, 0.01), variance ~ U(0.5, 1.5)
        lambda path, s: (0.1 * rng.standard_normal(s.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, s.shape)).astype(np.float32),
        jax.eval_shape(enc.init_variables, jax.random.key(0))["batch_stats"])
    variables = {"params": random_params(lambda k: enc.init_variables(k)["params"], 50), "batch_stats": stats}
    port = TorchEncoder()
    port.load_state_dict(to_torch(audio_encoder_state_dict(variables)), strict=True)
    return enc, variables, port.eval()


@pytest.fixture(scope="module")
def port_encodings(dataset_dir, encoders, tmp_path_factory):
    d = tmp_path_factory.mktemp("encodings")
    got = tprep.encode_audio_dataset(dataset_dir, str(d / "torch.p"), encoders[2], device="cpu")
    with open(d / "torch.p", "rb") as fh:
        assert pickle.load(fh).keys() == got.keys()
    return got


def test_encode_audio_dataset_matches_jax(dataset_dir, encoders, port_encodings, tmp_path):
    enc, variables, _ = encoders
    want = jprep.encode_audio_dataset(dataset_dir, str(tmp_path / "jax.p"), enc, variables)
    assert port_encodings.keys() == want.keys() and len(want) == 4
    scale = max(np.abs(w).max() for w in want.values())
    for f in want:
        assert port_encodings[f].shape == (100,) and port_encodings[f].dtype == np.float32
        np.testing.assert_allclose(port_encodings[f], want[f], atol=1e-4 * scale)


def test_data_clis_in_a_subprocess(audio_dir, dataset_dir, encoders, port_encodings, tmp_path):
    """``python -m audio_diffusion_torch.scripts.audio_to_images`` and then
    ``...encode_audio --pretrained_encoder``, run as ``-m`` runs them (runpy)
    in one CPU subprocess, give what the functions give in this process."""
    encoders[2].save_pretrained(str(tmp_path / "encoder"))
    out, enc_file = str(tmp_path / "cli_ds"), str(tmp_path / "cli.p")
    argvs = [["audio_diffusion_torch.scripts.audio_to_images", "--input_dir", audio_dir, "--output_dir", out,
              "--resolution", str(RES), "--device", "cpu"],
             ["audio_diffusion_torch.scripts.encode_audio", "--dataset", out, "--output_file", enc_file,
              "--pretrained_encoder", str(tmp_path / "encoder"), "--device", "cpu"]]
    code = ("import runpy, sys\n"
            f"for argv in {argvs!r}:\n"
            "    sys.argv = argv\n"
            "    runpy.run_module(argv[0], run_name='__main__', alter_sys=True)\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cli_ds, ds = ImageSliceDataset(out), ImageSliceDataset(dataset_dir)
    assert len(cli_ds) == len(ds)
    for i in range(len(ds)):
        np.testing.assert_array_equal(cli_ds.get(i)["image"], ds.get(i)["image"])
    with open(enc_file, "rb") as fh:
        got = pickle.load(fh)
    assert got.keys() == port_encodings.keys()
    for f in got:
        np.testing.assert_array_equal(got[f], port_encodings[f])


def test_data_entry_points_raise_without_cuda(monkeypatch, audio_dir, dataset_dir, tmp_path):
    from audio_diffusion_torch.scripts import audio_to_images, encode_audio

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        audio_to_images.main(["--input_dir", audio_dir, "--output_dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_audio.main(["--dataset", dataset_dir, "--output_file", str(tmp_path / "x.p")])


# ----------------------------------------------------------- host decoders

def test_native_decoder_copy_matches_jax(audio_dir, tmp_path):
    """The ctypes copy loads the same libraries as the JAX module and decodes
    and resamples bit for bit alike; load_audio routes the same way."""
    assert tnative.available() == jnative.available()
    paths = [os.path.join(audio_dir, f) for f in (*GOOD, "e_junk.wav")]
    if tnative.available():
        for path in paths[:4]:
            np.testing.assert_array_equal(tnative.load_wav(path, 22050), jnative.load_wav(path, 22050))
        got, want = tnative.load_batch(paths, 22050, n_threads=2), jnative.load_batch(paths, 22050, n_threads=2)
        assert got[-1] is None and want[-1] is None
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(g, w)
        x = synth_audio(4410)
        np.testing.assert_array_equal(tnative.resample(x, 44100, 22050), jnative.resample(x, 44100, 22050))
    for path in paths[:4]:
        np.testing.assert_array_equal(audio_io.load_audio(path, 22050), jax_audio_io.load_audio(path, 22050))
    assert audio_io.decoder_for(paths[1]) == ("native" if tnative.available() else "scipy")
    assert tnative.media_available() == jnative.media_available()
    if tnative.media_available():
        src = synth_audio(22050)
        m4a = str(tmp_path / "clip.m4a")
        assert tnative.encode_media(m4a, src, 22050)
        np.testing.assert_array_equal(tnative.load_media(m4a, 22050), jnative.load_media(m4a, 22050))
        np.testing.assert_array_equal(audio_io.load_audio(m4a, 22050), jax_audio_io.load_audio(m4a, 22050))
        assert audio_io.decoder_for(m4a) == "native-media"


# ------------------------------------------------------------------- Hub ids

def _fake_cache(root, model_id, commit="0123abc"):
    repo = root / ("models--" + model_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit)
    snapshot = repo / "snapshots" / commit
    snapshot.mkdir(parents=True)
    return str(snapshot)


def test_hub_ids_resolve_from_a_local_cache_only(tmp_path, monkeypatch):
    """The hand-read cache layout against huggingface_hub's own offline
    lookup; $HF_HUB_CACHE, then $HF_HOME/hub; AudioDiffusion and the
    trainer's VAE loader load by id; an uncached id raises the actionable
    error; pushing raises."""
    from huggingface_hub import snapshot_download

    from test_torch_pipeline import UNET_KW, VAE_KW, _pair

    from audio_diffusion_torch.training.loop import load_vae

    for name in ("teticio/audio-diffusion-256", "user/model.v2", "just-a-name", "a/b/c", "/abs/path", "./rel/path"):
        assert thub.looks_like_model_id(name) == jhub.looks_like_model_id(name)
    snapshot = _fake_cache(tmp_path / "hub", "user/tiny-model")
    assert snapshot_download("user/tiny-model", local_files_only=True, cache_dir=str(tmp_path / "hub")) == snapshot
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert thub.resolve_pretrained("user/tiny-model") == snapshot
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    with pytest.raises(FileNotFoundError, match="user/tiny-model.*not in the local HF cache"):
        thub.resolve_pretrained("user/tiny-model")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert thub.resolve_pretrained("user/tiny-model") == snapshot
    assert thub.resolve_pretrained(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="neither a local directory nor a Hub model id"):
        thub.resolve_pretrained("no-such-directory-anywhere")

    _, tpipe = _pair(dict(UNET_KW, fused_groupnorm=False), VAE_KW)
    tpipe.save_pretrained(snapshot)
    ad = AudioDiffusion("user/tiny-model", device="cpu")
    assert ad.pipe.unet.config == tpipe.unet.config and ad.pipe.vqvae.config == tpipe.vqvae.config
    assert load_vae("user/tiny-model", "cpu").config == tpipe.vqvae.config  # the trainer's --vae
    with pytest.raises(FileNotFoundError, match="huggingface-cli download user/missing-model"):
        AudioDiffusion("user/missing-model", device="cpu")
    for push in (lambda: thub.ensure_repo(None, str(tmp_path)), lambda: thub.push_folder(str(tmp_path), "u/m")):
        with pytest.raises(RuntimeError, match="no network path"):
            push()
