"""Port parity of the LDM-layout VAE import and the profiling utilities on the
CPU: ``ldm_vae_to_diffusers`` gives the JAX function's keys and arrays
exactly (training-only ``loss.*`` dropped, the ``first_stage_model.`` prefix
stripped, unmapped attention refused); the converted VAE loads strict=True
and decodes like the JAX ``convert_ldm_vae`` model within 1e-5 of max |ref|;
``python -m audio_diffusion_torch.scripts.convert_checkpoint`` turns a
Lightning .ckpt and its yaml into a diffusers-layout directory that the
trainer's ``--vae`` loader reads; ``trace`` writes a Chrome trace, with the
program's spans in it."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_import import _diffusers_vae_sd_to_ldm

from audio_diffusion_torch.models.vae import AutoencoderKL as TorchVAE
from audio_diffusion_torch.models.vae import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.training.loop import load_vae
from audio_diffusion_torch.utils import ldm_import, profiling
from audio_diffusion_tpu.models.vae import AutoencoderKL
from audio_diffusion_tpu.utils import torch_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DDCONFIG = {"double_z": True, "z_channels": 2, "resolution": 32, "in_channels": 1, "out_ch": 1, "ch": 32,
            "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}


@pytest.fixture(scope="module")
def ldm_sd():
    """An LDM-layout checkpoint state dict: a seeded port VAE renamed by the
    inverse of the converter, with the training-only loss.* entries."""
    cfg = ldm_import.vae_config_from_ldm(DDCONFIG)
    vae = TorchVAE(cfg).init_params(torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    out = _diffusers_vae_sd_to_ldm(sd, cfg)
    out["loss.discriminator.main.0.weight"] = np.zeros((4, 1, 4, 4), np.float32)
    out["loss.perceptual_loss.net.slice1.0.weight"] = np.zeros((4,), np.float32)
    return out


@pytest.mark.parametrize("prefix", ["", "first_stage_model."])
def test_ldm_rename_matches_jax(ldm_sd, prefix):
    sd = {prefix + k: v for k, v in ldm_sd.items()}
    got, want = ldm_import.ldm_vae_to_diffusers(sd), torch_import.ldm_vae_to_diffusers(sd)
    assert sorted(got) == sorted(want) and not any(k.startswith("loss.") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert sorted(got) == sorted(TorchVAE(ldm_import.vae_config_from_ldm(DDCONFIG)).state_dict())
    bad = {"encoder.conv_in.weight": np.zeros((8, 1, 3, 3), np.float32),
           "decoder.up.0.attn.0.q.weight": np.zeros((8, 8, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="attn_resolutions"):
        ldm_import.ldm_vae_to_diffusers(bad)


def test_vae_config_from_ldm_matches_jax():
    """The reference's ddconfig (config/ldm_autoencoder_kl.yaml:18-28) and the small one."""
    reference = dict(DDCONFIG, z_channels=1, resolution=256, ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2)
    for dd in (reference, DDCONFIG):
        want = torch_import.vae_config_from_ldm(dd)
        got = ldm_import.vae_config_from_ldm(dd)
        assert got == TorchVAEConfig(**{f: getattr(want, f) for f in ("in_channels", "out_channels",
                                                                       "block_out_channels", "layers_per_block",
                                                                       "latent_channels", "sample_size",
                                                                       "norm_num_groups", "scaling_factor")})
    assert ldm_import.vae_config_from_ldm(reference).block_out_channels == (128, 256, 512, 512)


def test_converted_vae_decodes_like_jax(ldm_sd):
    config, params = torch_import.convert_ldm_vae(ldm_sd, DDCONFIG)
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 2)).astype(np.float32)
    want = np.asarray(AutoencoderKL(config).apply({"params": params}, jnp.asarray(z),
                                                  method=AutoencoderKL(config).decode))
    vae = TorchVAE(ldm_import.vae_config_from_ldm(DDCONFIG))
    vae.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in ldm_import.ldm_vae_to_diffusers(ldm_sd).items()},
                        strict=True)
    with torch.no_grad():
        got = vae.eval().decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_convert_checkpoint_cli_in_a_subprocess(ldm_sd, tmp_path):
    ckpt, config, out = str(tmp_path / "last.ckpt"), str(tmp_path / "ldm.yaml"), str(tmp_path / "vae")
    torch.save({"state_dict": {k: torch.from_numpy(v.copy()) for k, v in ldm_sd.items()}, "epoch": 3}, ckpt)
    with open(config, "w") as fh:
        yaml.safe_dump({"model": {"params": {"ddconfig": DDCONFIG}}}, fh)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-m", "audio_diffusion_torch.scripts.convert_checkpoint", "--input", ckpt,
                           "--ldm_config", config, "--output", out], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "diffusers-vae" in proc.stdout
    with open(os.path.join(out, "config.json")) as fh:
        assert json.load(fh)["_class_name"] == "AutoencoderKL"
    loaded = load_vae(out, "cpu")
    want = ldm_import.ldm_vae_to_diffusers(ldm_sd)
    assert loaded.config == ldm_import.vae_config_from_ldm(DDCONFIG)
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_profiling_trace_and_step_timer(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]


def test_profiling_trace_writes_the_programs_spans_around_the_ops_inside(tmp_path):
    """A span recorded while ``trace`` runs lands in the Chrome trace on the
    file's own time base, enclosing the torch op run inside it, on a row of
    its thread; a span recorded with no profiler running is recorded nowhere."""
    before = profiling.spans()
    with profiling.span("outside", batch=0):
        torch.ones(4).sum()
    assert profiling.spans() == before
    with profiling.trace(str(tmp_path)):
        with profiling.span("adt.test.region", batch=7):
            torch.ones(64).mul(3.0)
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    (mine,) = [e for e in events if e.get("cat") == "adt_span"]
    (op,) = [e for e in events if e.get("name") == "aten::mul" and e.get("ph") == "X"]
    assert mine["name"] == "adt.test.region" and mine["args"] == {"batch": 7}
    assert mine["ts"] <= op["ts"] and op["ts"] + op["dur"] <= mine["ts"] + mine["dur"]
    names = [e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("tid") == mine["tid"]]
    assert names == ["MainThread (spans)"]
    assert profiling.spans()[-1].name == "adt.test.region"
