"""The port's pinned-seed rebuild recipes (``scripts.rebuild_latent256`` and
``scripts.rebuild_latent512`` over ``scripts/rebuild.py``) on the CPU at
small widths (32x32 mels, a 32/64-channel VAE, a small UNet to start from,
a few steps each):

- ``write_png_dataset`` against the JAX package's HF ``audio_to_images`` from
  the same WAVs: the same slices, images within 1 uint8, in the same order
  through both packages' ``ImageSliceDataset``, a file of 12 slices included
  (unpadded names would sort slice 10 before slice 2).
- The 256 recipe through its entry point in a process where ``datasets``
  and pandas cannot be imported: every stage runs, the UNet's loss falls,
  nothing of JAX is imported, and a rerun reuses every finished stage. The
  saved pipeline loads in both packages and one request with injected noise
  gives the same uint8 spectrogram (at most 1 apart on at most 0.5% of the
  pixels, test_torch_pipeline.py's bound).
- ``fidelity_record`` against the JAX scripts' closing arithmetic, written
  again here with JAX package calls, on the same weights and injected noise:
  the VAE MAE within 1e-3, each nearest-neighbour MAE within 0.5.
- The conditional recipe: the encodings are keyed by PNG path, one per WAV,
  and the trainer consumes them.
- ``bench``'s trained-weights side run, with ``TRAINED_256_DIR`` pointed at
  the rebuilt pipeline and the random-init pipeline built small.

The VAE is 32/64 channels wide because the bench's bf16-against-f32 VAE gate
(2.0 uint8) holds there: an 8/16-channel VAE in bf16 drifts 2.6-3.5 uint8 from
f32 at these shapes, a property of so few channels per group.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _assert_uint8_close, one_intra_op_thread  # noqa: F401 (a fixture)

from audio_diffusion_torch import bench
from audio_diffusion_torch.data.dataset import ImageSliceDataset as TorchDataset
from audio_diffusion_torch.data.prepare import write_png_dataset
from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler
from audio_diffusion_torch.scripts import make_audio, rebuild
from audio_diffusion_tpu.data.dataset import ImageSliceDataset, normalize_image
from audio_diffusion_tpu.data.prepare import audio_to_images
from audio_diffusion_tpu.models import UNet2D as JaxUNet
from audio_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from audio_diffusion_tpu.pipelines import AudioDiffusionPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
UNET = dict(block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
            up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=4,
            attention_head_dim=8)
COND_UNET = dict(UNET, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), attention_head_dim=4, cross_attention_dim=100)
EVAL_BATCH, EVAL_STEPS = 4, 3
VAE_MAE_TOL, NN_MAE_TOL = 1e-3, 0.5
# Every recipe flag after the pinned ones: 8 files x 2 slices (the UNet's batch of 16), 32x32 mels
CUT = ["--device", "cpu", "--files", "8", "--resolution", str(RES), "--vae_steps", "6", "--disc_start", "3",
       "--unet_steps", "20", "--unet_warmup", "1", "--vae_base_channels", "32", "--vae_ch_mult", "1,2",
       "--vae_norm_num_groups", "8", "--eval_batch", str(EVAL_BATCH), "--eval_steps", str(EVAL_STEPS),
       "--bench_batch", "2", "--bench_steps", "2", "--bench_iters", "1", "--bench_reps", "1"]
# The entry point in a process where datasets and pandas cannot be imported; it must import no JAX either
BLOCKED = ("import runpy, sys; sys.modules['datasets'] = sys.modules['pandas'] = None; "
           "runpy.run_module('audio_diffusion_torch.scripts.rebuild_latent256', run_name='__main__'); "
           "bad = [m for m in ('jax', 'flax', 'audio_diffusion_tpu', 'datasets', 'pandas') if sys.modules.get(m)]; "
           "assert not bad, bad")


def _start_pipe(path, unet_kw):
    """A small pixel pipeline whose UNet (16x16, the VAE's latent grid) the trainer starts from."""
    cfg = UNetConfig(sample_size=(RES // 2, RES // 2), **unet_kw)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0))
    mel = TorchMel(x_res=RES, y_res=RES, hop_length=512, n_iter=4, device="cpu")
    TorchPipeline(unet, mel, DDIMScheduler(), device="cpu").save_pretrained(str(path))
    return str(path)


def _run_blocked(args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", BLOCKED, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, f"--- stdout ---\n{proc.stdout[-3000:]}\n--- stderr ---\n{proc.stderr[-3000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rebuilt(tmp_path_factory):
    """The 256 recipe, cut, through its entry point without datasets and pandas, run twice."""
    root = tmp_path_factory.mktemp("rebuild256")
    args = ["--output", str(root / "out"), "--from_pretrained", _start_pipe(root / "start", UNET), *CUT]
    first = _run_blocked(args, str(root))
    return {"first": first, "second": _run_blocked(args, str(root)), "out": str(root / "out"),
            "ds": os.path.join(first["work"], "ds")}


@pytest.fixture(scope="module")
def jax_rebuilt(rebuilt):
    """The rebuilt pipeline through the JAX package's torch-import route. Its check of the converted weights
    needs only the shapes of flax's init, which runs op by op on the CPU, so the template comes from
    jax.eval_shape (as test_torch_pipeline_interop.py makes it)."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxUNet, JaxVAE):
            def shapes_only(self, key, init=cls.init_params):
                return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda k: init(self, k), key))

            mp.setattr(cls, "init_params", shapes_only)
        return AudioDiffusionPipeline.from_pretrained(rebuilt["out"])


def test_png_dataset_reads_as_the_jax_hf_dataset(tmp_path):
    audio = tmp_path / "audio"
    make_audio.main(["--output_dir", str(audio), "--files", "2", "--slices", "2", "--resolution", str(RES)])
    make_audio.main(["--output_dir", str(tmp_path / "long"), "--files", "1", "--slices", "12", "--resolution",
                     str(RES), "--seed", "3"])
    os.replace(tmp_path / "long" / "clip_000.wav", audio / "clip_001b.wav")  # between clip_001 and clip_002 as a name
    files = write_png_dataset(TorchMel(x_res=RES, y_res=RES, hop_length=512, device="cpu"), str(audio),
                              str(tmp_path / "png"))
    audio_to_images(str(audio), str(tmp_path / "hf"), resolution=(RES, RES), hop_length=512)
    hf, port_png, jax_png = (ImageSliceDataset(str(tmp_path / "hf")), TorchDataset(str(tmp_path / "png")),
                             ImageSliceDataset(str(tmp_path / "png")))
    assert len(hf) == len(port_png) == len(jax_png) == len(files) == 16
    for i in range(len(hf)):
        want, got, also = hf.get(i), port_png.get(i), jax_png.get(i)
        assert files[got["audio_file"]] == want["audio_file"] and got["audio_file"] == also["audio_file"]
        assert int(got["audio_file"][-9:-4]) == want["slice"]
        np.testing.assert_array_equal(got["image"], also["image"])
        assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1
    assert [hf.get(i)["slice"] for i in range(4, 16)] == list(range(12))


def test_rebuild_256_runs_every_stage_without_datasets_and_reuses_them(rebuilt):
    first, second = rebuilt["first"], rebuilt["second"]
    assert list(first["stages"]) == ["corpus", "dataset", "vae", "unet", "bench", "fidelity"]
    assert not any(s["reused"] for s in first["stages"].values())
    assert first["stages"]["dataset"]["slices"] == 16 and first["stages"]["vae"]["steps"] == 6
    unet = first["stages"]["unet"]
    assert unet["steps"] == 20 and unet["loss_last_mean"] < unet["loss_first_mean"]
    assert [s["reused"] for s in second["stages"].values()] == [True] * 4 + [False] * 2
    for r in (first, second):
        assert [line["config"]["dtype"] for line in r["bench"]] == ["float32", "bfloat16"]
        assert r["device"]["platform"] == "cpu" and len(r["fidelity"]["sample_nn_mae_uint8"]) == EVAL_BATCH
    assert second["fidelity"] == first["fidelity"]
    assert first["bounds"] == {"vae_recon_mae_uint8": 30.0, "sample_nn_mae_uint8": 50.0, "applied": False,
                               "missed": []}


def test_pinned_256_record_is_held_to_its_bounds():
    """At the pinned depth the 256 recipe fails on a record above its bounds; a cut run is not held to them."""
    assert rebuild.parse_args(rebuild.LATENT_256, []).pinned
    assert rebuild.parse_args(rebuild.LATENT_256, ["--output", "x", "--bench_batch", "2", "--bench_bf16_only"]).pinned
    assert not rebuild.parse_args(rebuild.LATENT_256, CUT).pinned
    jax_recipe = {"vae_recon_mae_uint8": 21.4, "sample_nn_mae_uint8": [30.7, 33.9], "sample_std_uint8": 40.0}
    assert rebuild.missed_bounds(rebuild.LATENT_256, jax_recipe) == []
    worse = {**jax_recipe, "vae_recon_mae_uint8": 30.0, "sample_nn_mae_uint8": [30.7, 72.0]}
    assert rebuild.missed_bounds(rebuild.LATENT_256, worse) == ["vae_recon_mae_uint8 30.0000 not under 30.0",
                                                                "sample_nn_mae_uint8 72.0000 not under 50.0"]
    assert rebuild.missed_bounds(rebuild.CONDITIONAL_512, worse) == []


def test_rebuilt_pipeline_answers_alike_in_both_packages(rebuilt, jax_rebuilt):
    tpipe, jpipe = TorchPipeline.from_pretrained(rebuilt["out"], device="cpu"), jax_rebuilt
    noise = np.random.default_rng(5).standard_normal((2, RES // 2, RES // 2, 1)).astype(np.float32)
    raw_t, _ = tpipe(noise=torch.from_numpy(noise), steps=EVAL_STEPS, return_arrays=True)
    raw_j, _ = jpipe(noise=jnp.asarray(noise), steps=EVAL_STEPS, return_arrays=True)
    _assert_uint8_close(raw_t.numpy(), np.asarray(raw_j))


def _jax_fidelity(pipe, ds_dir, noise):
    """rebuild_latent256.sh:48-78 with the generation's key replaced by injected noise."""
    ds = ImageSliceDataset(ds_dir)
    imgs = np.stack([ds.get(i)["image"] for i in range(len(ds))])
    x = jnp.asarray(normalize_image(imgs[-EVAL_BATCH:]))[..., None]
    p = pipe.vqvae_params
    rec = pipe.vqvae.apply({"params": p}, pipe.vqvae.apply({"params": p}, x, method=pipe.vqvae.encode).mode(),
                           method=pipe.vqvae.decode)
    rec_u8 = np.asarray(jnp.clip((rec[..., 0] / 2 + 0.5) * 255, 0, 255)).astype(np.uint8)
    vae_mae = float(np.abs(rec_u8.astype(float) - imgs[-EVAL_BATCH:].astype(float)).mean())
    raw = pipe(noise=jnp.asarray(noise), steps=EVAL_STEPS, return_images_only=True)
    nn_mae = [float(np.abs(imgs.astype(float) - r.astype(float)).mean(axis=(1, 2)).min()) for r in np.asarray(raw)]
    return vae_mae, nn_mae


def test_fidelity_record_matches_the_jax_arithmetic(rebuilt, jax_rebuilt):
    noise = np.random.default_rng(6).standard_normal((EVAL_BATCH, RES // 2, RES // 2, 1)).astype(np.float32)
    tpipe = TorchPipeline.from_pretrained(rebuilt["out"], fused_groupnorm=True, device="cpu")
    got = rebuild.fidelity_record(tpipe, rebuilt["ds"], batch=EVAL_BATCH, steps=EVAL_STEPS,
                                  noise=torch.from_numpy(noise))
    vae_mae, nn_mae = _jax_fidelity(jax_rebuilt, rebuilt["ds"], noise)
    assert abs(got["vae_recon_mae_uint8"] - vae_mae) <= VAE_MAE_TOL, (got, vae_mae)
    np.testing.assert_allclose(got["sample_nn_mae_uint8"], nn_mae, atol=NN_MAE_TOL)
    assert 0 < vae_mae < 255 and all(0 < v < 255 for v in nn_mae)


def test_conditional_rebuild_keys_encodings_by_png(tmp_path):
    # 4 files of 4 slices: the encoder runs once per file
    args = ["--output", str(tmp_path / "out"), "--from_pretrained", _start_pipe(tmp_path / "start", COND_UNET), *CUT,
            "--files", "4", "--slices", "4", "--bench_bf16_only"]
    result = rebuild.main(rebuild.CONDITIONAL_512, args)
    work = result["work"]
    with open(os.path.join(work, "encodings.p"), "rb") as fh:
        encodings = pickle.load(fh)
    pngs = TorchDataset(os.path.join(work, "ds"))._files
    assert list(encodings) == pngs and len(pngs) == 16
    with open(os.path.join(work, "ds", "slices.json")) as fh:
        wav_of = {os.path.join(work, "ds", png): wav for png, wav in json.load(fh).items()}
    for png, enc in encodings.items():
        assert enc.shape == (100,) and np.isfinite(enc).all()
        same_wav = [e for p, e in encodings.items() if wav_of[p] == wav_of[png]]
        assert len(same_wav) == 4 and all(np.array_equal(e, enc) for e in same_wav)
    assert len({e.tobytes() for e in encodings.values()}) == 4
    unet = result["stages"]["unet"]
    assert unet["steps"] == 20 and np.isfinite([unet["loss_first"], unet["loss_last"]]).all()
    saved = TorchPipeline.from_pretrained(result["output"], device="cpu")
    assert saved.unet.config.is_conditional and saved.vqvae.config.sample_size == RES
    assert [(line["config"]["dtype"], line["config"]["batch"]) for line in result["bench"]] == [("bfloat16", 2)]
    assert len(result["fidelity"]["sample_nn_mae_uint8"]) == EVAL_BATCH


def test_bench_takes_the_trained_side_run(rebuilt, monkeypatch, capsys):
    def small_latent_pipeline(resolution, dtype, fused_groupnorm, device, seed):
        """The random-init latent pipeline small, at 32x32, the rebuilt pipeline's output."""
        vae = AutoencoderKL(VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, sample_size=RES,
                                      dtype=dtype)).init_params(torch.Generator().manual_seed(seed + 1))
        unet = UNet2D(UNetConfig(sample_size=(RES // 2, RES // 2), **UNET, dtype=dtype,
                                 fused_groupnorm=fused_groupnorm)).init_params(torch.Generator().manual_seed(seed))
        mel = TorchMel(x_res=RES, y_res=RES, hop_length=512, device=device)
        return TorchPipeline(unet, mel, DDIMScheduler(), vae, device=device)

    monkeypatch.setattr(bench, "TRAINED_256_DIR", bench.Path(rebuilt["out"]))
    monkeypatch.setattr(bench, "TRAINED_256_HW", (RES, RES))
    monkeypatch.setattr(bench, "build_latent_pipeline", small_latent_pipeline)
    out = bench.main(["--device", "cpu", "--batch", "2", "--steps", "2", "--iters", "1", "--reps", "1", "--dtype",
                      "float32"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    trained = out["trained"]
    assert trained["pipeline"].endswith(os.path.join(*bench.Path(rebuilt["out"]).parts[-2:]))
    assert trained["dtype"] == "float32" and trained["value"] > 0 and trained["launches"]["requests"] == 1
    assert trained["fidelity"]["vae_dtype_mae"] == 0.0 and trained["fidelity"]["fused_staged_audio_lsb"] == 0
    assert out["config"]["pipeline"] == "latent random-init" and out["config"]["dtype"] == "float32"
