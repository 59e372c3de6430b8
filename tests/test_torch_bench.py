"""The port's measurement programs on the CPU at small sizes:
``python -m audio_diffusion_torch.bench``, ``scripts.stage_ledger``,
``scripts.mfu`` with ``utils/flops.py``, and ``scripts.bench_serving``.

- Each prints one JSON line naming its device, and without a card and
  without ``--device cpu`` exits non-zero and prints nothing.
- The bench's gates against the JAX package's own gate arithmetic, computed
  through ``audio_diffusion_tpu`` modules on the same inputs: the Griffin-Lim
  round-trip MAE with the JAX Griffin-Lim phase handed to the port, within
  0.05 uint8 (f32 Griffin-Lim in two implementations rounds a few pixels of
  the re-made image the other way; the bounds are whole uint8 levels apart);
  the bf16-against-f32 VAE MAE with the JAX VAE's weights carried across,
  within 25% (a mean of bf16 rounding noise, rounded at the same points in
  two orders of summation), the f32 round trips themselves within 1e-4.
- The fused-against-staged gate fails when the staged path is made to differ.
- The ledger's keys are the JAX ledger's, and its stage programs chained give
  the fused call's spectrograms bitwise.
- The FLOP count is the same with and without the kernel path and in either
  dtype, equals a count by hand from the modules' shapes exactly, and lies
  above XLA's count of the JAX UNet by exactly the taps XLA leaves out (on
  padding, and on the holes of the dilated upsample), XLA adding only its
  elementwise work (under 5% of its count).
- bench_serving answers through the batcher, and a failed request fails it.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import random_params
from test_torch_pipeline import MEL_KW, REPO, UNET_KW, VAE_KW, one_intra_op_thread  # noqa: F401 (a fixture)

from audio_diffusion_torch import bench
from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import AutoencoderKL as TorchVAE
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models import VAEConfig as TorchVAEConfig
from audio_diffusion_torch.models import unconditional_config as torch_unconditional_config
from audio_diffusion_torch.models.unet2d import SelfAttention2D, Upsample2D
from audio_diffusion_torch.models.vae import VAEAttention
from audio_diffusion_torch.pipelines import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.scripts import bench_serving, mfu, stage_ledger
from audio_diffusion_torch.serving import DynamicBatcher
from audio_diffusion_torch.utils import flops
from audio_diffusion_torch.utils.convert import to_torch, vae_state_dict
from audio_diffusion_tpu.mel import Mel
from audio_diffusion_tpu.models import UNet2D, unconditional_config
from audio_diffusion_tpu.models.vae import AutoencoderKL, VAEConfig

GL_MAE_TOL = 0.05
VAE_MAE_RTOL = 0.25
ELEMENTWISE_SHARE = 0.05  # XLA's elementwise FLOPs, at most this share of its count
JAX_BENCH_KEYS = ("metric", "value", "unit", "reps", "fidelity")
BENCH_KEYS = JAX_BENCH_KEYS + ("config", "setup", "launches", "device")
CONFIG_KEYS = ("batch", "steps", "resolution", "dtype", "fused_groupnorm", "fuse", "cudnn")
SETUP_KEYS = ("first_call_s", "warmup_s", "capture_s", "pool_bytes")


def _tiny_pipe(fused_groupnorm=True, dtype="float32"):
    unet = TorchUNet(TorchUNetConfig(**dict(UNET_KW, fused_groupnorm=fused_groupnorm, dtype=dtype)))
    vae = TorchVAE(TorchVAEConfig(**VAE_KW, dtype=dtype))
    unet.init_params(torch.Generator().manual_seed(0))
    vae.init_params(torch.Generator().manual_seed(1))
    return TorchPipeline(unet, TorchMel(**MEL_KW, device="cpu"), TorchDDIM(), vae, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _tiny_pipe()


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory, tiny):
    d = str(tmp_path_factory.mktemp("tiny_pipe"))
    tiny.save_pretrained(d)
    return d


def _one_json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


# ------------------------------------------------------------------- bench

@pytest.mark.parametrize("mode", [[], ["--latency"]], ids=["throughput", "latency"])
def test_bench_quick_on_the_cpu_prints_one_json_line(mode, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # batch 16 over 1,024 attention tokens: large ops, unlike the tiny pipelines
    try:
        out = bench.main(["--device", "cpu", "--quick", "--steps", "2", "--iters", "1", "--reps", "1", *mode])
    finally:
        torch.set_num_threads(threads)
    line = _one_json_line(capsys)
    assert line == json.loads(json.dumps(out))
    assert all(k in line for k in BENCH_KEYS)
    assert all(k in line["config"] for k in CONFIG_KEYS) and all(k in line["setup"] for k in SETUP_KEYS)
    assert line["device"] == {"platform": "cpu", "name": "cpu", "power_limit_w": None, "count": 0}
    assert line["value"] > 0 and len(line["reps"]) == 1
    assert line["config"]["resolution"] == [64, 64] and line["config"]["fused_groupnorm"] is True
    assert line["config"]["batch"] == (1 if mode else 16) and line["config"]["fuse"] is True
    assert line["unit"] == ("seconds (median)" if mode else "samples/sec/chip")
    # the CPU runs the kernels' plain versions and captures nothing: no launch, no capture time
    assert line["launches"]["group_norm_silu"] == line["launches"]["flash_mha"] == 0
    assert line["setup"]["capture_s"] is None and line["setup"]["pool_bytes"] is None
    fid = line["fidelity"]
    assert fid["fused_staged_audio_lsb"] == 0 and fid["gl_bound"] == 18.0 and 0 < fid["gl_roundtrip_mae"] < 18.0
    assert fid["vae_dtype_mae"] is None  # a pixel pipeline


def test_bench_no_fuse_runs_the_staged_programs_and_restores_the_pipeline(tiny, capsys):
    """--no-fuse: each request as the staged programs; a given pipeline is
    benched as it is and handed back with its own ``fuse``."""
    tiny._compiled.clear()
    out = bench.main(["--device", "cpu", "--no-fuse", "--batch", "2", "--steps", "2", "--iters", "2", "--reps", "2"],
                     pipe=tiny)
    assert _one_json_line(capsys)["config"] == out["config"]
    assert out["config"]["fuse"] is False and out["config"]["pipeline"] == "given" and tiny.fuse is True
    assert out["metric"].startswith("32x32 latent mel samples/sec/chip") and len(out["reps"]) == 2
    assert 0 <= out["fidelity"]["vae_dtype_mae"] < bench.VAE_MAE_BOUND  # f32 against f32
    # the timed requests' programs are the stages; the gate's fused probe made the one fused program
    assert sum(k[0] == "fused" for k in tiny._compiled) == 1
    assert {k[0] for k in tiny._compiled} == {"fused", "denoise", "vae_decode", "audio"}


@pytest.mark.parametrize("module, extra", [
    ("audio_diffusion_torch.bench", []),
    ("audio_diffusion_torch.scripts.stage_ledger", []),
    ("audio_diffusion_torch.scripts.mfu", ["--no_time"]),
    ("audio_diffusion_torch.scripts.bench_serving", ["--model", "no-such-dir"]),
])
def test_without_a_card_each_program_exits_non_zero_with_no_value(module, extra):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", module, *extra], capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout)
    assert "torch.cuda.is_available() is False" in r.stderr


def test_the_measurement_programs_import_no_jax():
    code = ("import sys, audio_diffusion_torch.bench, audio_diffusion_torch.scripts.stage_ledger, "
            "audio_diffusion_torch.scripts.mfu, audio_diffusion_torch.scripts.bench_serving, "
            "audio_diffusion_torch.utils.flops, audio_diffusion_torch.utils.measure; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'audio_diffusion_tpu', 'bench') if m in sys.modules]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("geometry", [(64, 64, 512), (256, 256, 512)], ids=["quick", "256"])
@pytest.mark.parametrize("projection", ["fft", "matmul"])
def test_gl_gate_matches_the_jax_arithmetic(geometry, projection):
    """bench.py:168-189 through the JAX Mel, and the port's gate with the JAX
    Griffin-Lim phase (mel_to_audio's draw from key 0)."""
    y, x, hop = geometry
    jmel = Mel(x_res=x, y_res=y, hop_length=hop)
    tmel = TorchMel(x_res=x, y_res=y, hop_length=hop, device="cpu")
    audio = bench.probe_audio(tmel)
    img = np.asarray(jmel.spectrogram_images_from_audio(audio[None]))[0]
    rec = np.asarray(jmel.images_to_audio(img[None]))[0]
    img2 = np.asarray(jmel.spectrogram_images_from_audio(np.pad(rec, (0, jmel.slice_size - rec.shape[0]))[None]))[0]
    jax_mae = np.abs(img.astype(float) - img2.astype(float)).mean()
    phase = torch.from_numpy(np.array(2.0 * jnp.pi * jax.random.uniform(jax.random.key(0), (1, x, 1025))))
    mae = bench.gl_roundtrip_mae(tmel, projection, phase)
    assert abs(mae - jax_mae) <= GL_MAE_TOL, (mae, jax_mae)
    assert bench.gl_bound(tmel) == {(64, 64, 512): 18.0, (256, 256, 512): 2.41 + 1.1}[geometry]
    assert mae < bench.gl_bound(tmel)


def test_vae_dtype_gate_matches_the_jax_arithmetic():
    """bench.py:191-207: the JAX VAE's weights carried into the port, the
    bf16 round trip against the f32 one in both packages."""
    cfg = VAEConfig(**VAE_KW, dtype="bfloat16")
    params = random_params(AutoencoderKL(cfg).init_params, 12)
    tmel = TorchMel(**MEL_KW, device="cpu")
    img = tmel.spectrogram_images_from_audio(bench.probe_audio(tmel)[None]).numpy()
    x = jnp.asarray(img.astype(np.float32) / 255.0 * 2 - 1)[..., None]

    def roundtrip(vae):
        z = vae.apply({"params": params}, x, method=vae.encode).mode()
        return np.asarray(vae.apply({"params": params}, z, method=vae.decode), dtype=np.float32)

    rec_b, rec_32 = roundtrip(AutoencoderKL(cfg)), roundtrip(AutoencoderKL(dataclasses.replace(cfg, dtype="float32")))
    jax_mae = np.abs(rec_b - rec_32).mean() * 127.5

    tvae = TorchVAE(TorchVAEConfig(**VAE_KW, dtype="bfloat16"))
    tvae.load_state_dict(to_torch(vae_state_dict(params, cfg)), strict=True)
    mae = bench.vae_dtype_mae(tvae.eval(), tmel)
    assert jax_mae > 0 and abs(mae - jax_mae) <= VAE_MAE_RTOL * jax_mae, (mae, jax_mae)
    t32 = TorchVAE(TorchVAEConfig(**VAE_KW))
    t32.load_state_dict(to_torch(vae_state_dict(params, cfg)), strict=True)
    with torch.inference_mode():
        xt = torch.from_numpy(np.array(x))
        got = t32.eval().decode(t32.encode(xt).mode()).numpy()
    np.testing.assert_allclose(got, rec_32, rtol=0, atol=1e-4)


def _skew(stage, change):
    """A stand-in _stage_body whose ``stage`` output is changed by ``change``."""
    body = TorchPipeline._stage_body

    def skewed(self, prog, j):
        body(self, prog, j)
        if prog.key[0] == stage:
            key = "raw" if stage == "vae_decode" else "audio"
            prog.state[key] = change(prog.state[key])

    return skewed


@pytest.mark.parametrize("stage, change, match", [
    ("vae_decode", lambda raw: raw ^ 1, "spectrograms"),
    ("audio", lambda pcm: pcm + 3, "int16 LSB"),
], ids=["spectrograms", "audio"])
def test_fused_staged_gate_fails_when_the_staged_path_differs(stage, change, match, monkeypatch):
    pipe = _tiny_pipe()
    assert bench.fused_staged_gate(pipe) == 0
    monkeypatch.setattr(TorchPipeline, "_stage_body", _skew(stage, change))
    pipe._compiled.clear()
    with pytest.raises(bench.FidelityError, match=match):
        bench.fused_staged_gate(pipe)
    assert pipe.fuse is True


def test_gl_and_vae_gates_fail_above_their_bounds(tiny, monkeypatch):
    monkeypatch.setattr(bench, "GL_LOOSE_BOUND", 1e-3)
    with pytest.raises(bench.FidelityError, match="GL round-trip"):
        bench.fidelity_gate(tiny)
    monkeypatch.undo()
    monkeypatch.setattr(bench, "VAE_MAE_BOUND", -1.0)
    with pytest.raises(bench.FidelityError, match="VAE round trip"):
        bench.fidelity_gate(tiny)


def test_a_capture_inside_the_timed_window_fails(tiny, monkeypatch):
    """The warm-up must run the timed signature: a window that makes a program fails."""
    args = bench.parse_args(["--device", "cpu", "--batch", "2", "--steps", "2", "--iters", "2", "--reps", "1"])
    calls = []
    call = TorchPipeline.__call__

    def first_calls_differ(self, **kw):
        calls.append(1)
        return call(self, **dict(kw, steps=kw["steps"] + len(calls)))

    monkeypatch.setattr(TorchPipeline, "__call__", first_calls_differ)
    with pytest.raises(RuntimeError, match="timed window captured"):
        bench._measure(tiny, args, "latent ", False)


# ------------------------------------------------------------------- ledger

def _jax_ledger_keys(steps, n_iter):
    """The stage keys scripts/stage_ledger.py writes into its ledger."""
    with open(os.path.join(REPO, "scripts", "stage_ledger.py")) as f:
        keys = re.findall(r'ledger\[f?"([^"]+)"\]', f.read())
    return {k.replace("{steps}", str(steps)).replace("{mel.n_iter}", str(n_iter)) for k in keys}


def test_stage_ledger_keys_and_chained_stages(tiny, capsys):
    out = stage_ledger.main(["--device", "cpu", "--batch", "2", "--steps", "3", "--reps", "2", "--seed", "5"],
                            pipe=tiny)
    assert _one_json_line(capsys) == json.loads(json.dumps(out))
    keys = _jax_ledger_keys(3, MEL_KW["n_iter"])
    assert len(keys) == 7 and set(out["ms_per_batch"]) == keys
    assert all(v >= 0 for v in out["ms_per_batch"].values()) and out["fused_e2e_ms"] > 0
    assert math.isclose(out["stage_sum_ms"], sum(out["ms_per_batch"].values()))
    assert out["staged_matches_fused"] == {"spectrograms_bitwise": True, "audio_max_lsb": 0}
    assert out["device"]["platform"] == "cpu" and out["config"]["batch"] == 2

    # the ledger's stage programs chained on its noise against a fused call on the same noise
    fixed = tiny._fixed_key()
    denoise = tiny._compiled[("denoise", 3, 0, 0.0, 0, 0, "none", None, 2) + fixed]
    decode = tiny._compiled[("vae_decode", 2) + fixed]
    with torch.inference_mode():
        tiny._stage_body(denoise, 0)
        decode.inputs["x"].copy_(denoise.state["x"])
        tiny._stage_body(decode, 0)
    raw, _ = tiny(noise=denoise.inputs["x"].clone(), steps=3, return_arrays=True)
    assert torch.equal(decode.state["raw"], raw)


# -------------------------------------------------------------------- flops

def _count_by_hand(module, call, valid_taps=False, dilated_upsample=False) -> int:
    """2 x multiply-adds of every convolution, linear layer and attention
    product of ``call()``, from the shapes each module sees. ``valid_taps``:
    a convolution counts only the taps that land inside its input, as XLA's
    cost analysis does; ``dilated_upsample``: the nearest-x2 + 3x3 convs as the
    JAX package's 4-tap lhs-dilated conv on the small input."""
    total = []

    def taps(n_in, n_out, k, stride, pad):
        if not valid_taps:
            return n_out * k
        return sum(1 for o in range(n_out) for r in range(k) if 0 <= o * stride + r - pad < n_in)

    def dilated_taps(n_in, n_out):  # 4 taps over the input dilated by 2 and padded by 2
        return sum(1 for o in range(n_out) for r in range(4) if 0 <= o + r - 2 <= 2 * (n_in - 1) and (o + r) % 2 == 0)

    upsample_convs = {m.conv for m in module.modules() if isinstance(m, Upsample2D)}

    def conv(m, args, out):
        b, c, h, w = args[0].shape
        _, o, ho, wo = out.shape
        if dilated_upsample and m in upsample_convs:
            per_out = dilated_taps(h // 2, ho) * dilated_taps(w // 2, wo)
        else:
            per_out = (taps(h, ho, m.kernel_size[0], m.stride[0], m.padding[0])
                       * taps(w, wo, m.kernel_size[1], m.stride[1], m.padding[1]))
        total.append(2 * b * c // m.groups * o * per_out)

    def linear(m, args, out):
        total.append(2 * args[0][..., 0].numel() * m.in_features * m.out_features)

    def attention(m, args, out):
        b, c, h, w = args[0].shape
        total.append(4 * b * (h * w) ** 2 * c)  # heads x d = c

    hooks = []
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, (SelfAttention2D, VAEAttention)):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.inference_mode():
            out = call()
    finally:
        for h in hooks:
            h.remove()
    if isinstance(module, TorchUNet):  # conv_out is a functional 3x3 conv
        cfg, (b, h, w, o) = module.config, out.shape
        total.append(2 * b * cfg.block_out_channels[0] * o * taps(h, h, 3, 1, 1) * taps(w, w, 3, 1, 1))
    return sum(total)


def test_flop_count_is_the_same_on_either_path_and_dtype():
    counts = {(fused, dtype): flops.unet_forward_flops(TorchUNetConfig(**dict(UNET_KW, fused_groupnorm=fused,
                                                                               dtype=dtype)), 3)
              for fused in (True, False) for dtype in ("float32", "bfloat16")}
    assert len(set(counts.values())) == 1, counts


@pytest.mark.parametrize("batch", [1, 2, 5])
def test_flop_count_matches_a_count_by_hand(batch):
    cfg = TorchUNetConfig(**UNET_KW)
    unet = TorchUNet(cfg).eval()
    h, w = cfg.sample_hw()
    by_hand = _count_by_hand(unet, lambda: unet(torch.zeros((batch, h, w, 1)), torch.tensor(0)))
    assert flops.unet_forward_flops(cfg, batch) == by_hand
    vcfg = TorchVAEConfig(**VAE_KW)
    vae = TorchVAE(vcfg).eval()
    lh, lw = vcfg.latent_hw(32, 32)
    by_hand = _count_by_hand(vae, lambda: vae.decode(torch.zeros((batch, lh, lw, 1))))
    assert flops.vae_decode_flops(vcfg, (32, 32), batch) == by_hand


@pytest.mark.parametrize("dilated", [True, False], ids=["dilated_upsample", "nearest_upsample"])
def test_flop_gap_to_xla_is_the_taps_xla_leaves_out(dilated, capsys):
    """The latent-256 UNet at full width, batch 1: XLA's count of the JAX
    UNet (lowered, not compiled) is this module's nominal count less the
    taps on padding (and on the dilated upsample's holes), plus XLA's
    elementwise FLOPs."""
    cfg = unconditional_config(sample_size=(32, 32), dilated_upsample=dilated)
    model = UNet2D(cfg)
    lowered = jax.jit(lambda p, x, t: model.apply({"params": p}, x, t)).lower(
        jax.eval_shape(model.init_params, jax.random.key(0)), jax.ShapeDtypeStruct((1, 32, 32, 1), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.int32))
    cost = lowered.cost_analysis()
    xla = float((cost[0] if isinstance(cost, list) else cost)["flops"])

    tcfg = torch_unconditional_config(sample_size=(32, 32))
    ours = flops.unet_forward_flops(tcfg)
    unet = flops._stand_in(TorchUNet, tcfg)
    x = torch.zeros((1, 32, 32, 1))
    nominal = _count_by_hand(unet, lambda: unet(x, torch.tensor(0)))
    valid = _count_by_hand(unet, lambda: unet(x, torch.tensor(0)), valid_taps=True, dilated_upsample=dilated)
    elementwise = xla - valid
    with capsys.disabled():
        print(f"\n[flops] latent-256 UNet forward, batch 1: ours {ours / 1e9:.4f} GFLOP (nominal taps); "
              f"XLA {xla / 1e9:.4f} (dilated_upsample={dilated}) = valid taps {valid / 1e9:.4f} + elementwise "
              f"{elementwise / 1e9:.4f}; taps left out {(nominal - valid) / 1e9:.4f}")
    assert ours == nominal > valid
    assert 0 < elementwise <= ELEMENTWISE_SHARE * xla


def test_mfu_counts_without_timing_on_the_cpu(tiny, capsys):
    out = mfu.main(["--device", "cpu", "--no_time", "--batch", "4", "--steps", "3"], pipe=tiny)
    assert _one_json_line(capsys) == json.loads(json.dumps(out))
    unet = 3 * flops.unet_forward_flops(tiny.unet.config, 4)
    vae = flops.vae_decode_flops(tiny.vqvae.config, (32, 32), 4)
    assert out["denoise_scan"]["gflops"] == unet / 1e9 and out["vae_decode"]["gflops"] == vae / 1e9
    assert out["request"]["gflops"] == (unet + vae) / 1e9
    assert "mfu" not in out and "ms" not in out["denoise_scan"]  # nothing timed, no device figure
    assert out["peak_precision"] == flops.peak_precision("float32") and out["device"]["platform"] == "cpu"
    with pytest.raises(ValueError, match="--no_time"):
        mfu.main(["--device", "cpu"], pipe=tiny)


def test_peak_follows_the_precision(monkeypatch):
    assert flops.peak_precision("bfloat16") == "bfloat16"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert flops.peak_precision("float32") == "float32" and flops.PEAK_TFLOPS["float32"] == 67.0
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert flops.peak_precision("float32") == "tf32" and flops.PEAK_TFLOPS["tf32"] == 495.0


# ------------------------------------------------------------- bench_serving

def test_bench_serving_answers_through_the_batcher(tiny_dir):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "audio_diffusion_torch.scripts.bench_serving", "--device", "cpu",
                        "--model", tiny_dir, "--clients", "4", "--max_batch", "2", "--seconds", "1", "--steps", "3"],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    with open(os.path.join(REPO, "scripts", "bench_serving.py")) as f:
        jax_keys = re.findall(r'^\s+"(\w+)":', f.read().split("json.dumps({", 1)[1], flags=re.M)
    assert jax_keys and all(k in out for k in jax_keys)
    assert out["served"] > 0 and out["failed"] == 0 and out["serving_samples_per_sec"] > 0
    assert out["config"]["direct_programs_made"] == 0 and out["device"]["platform"] == "cpu"


def test_bench_serving_fails_on_a_failed_request(tiny_dir, monkeypatch):
    submit = DynamicBatcher.submit

    def failing(self, seed=0, **kw):
        if seed == 2:
            raise ValueError("refused")
        return submit(self, seed=seed, **kw)

    monkeypatch.setattr(DynamicBatcher, "submit", failing)
    with pytest.raises(RuntimeError, match="client 2: ValueError: refused"):
        bench_serving.main(["--device", "cpu", "--model", tiny_dir, "--clients", "3", "--max_batch", "2",
                            "--seconds", "1", "--steps", "2"])
