"""Port parity of UNet training: the attention kernel's VJP (``FlashMHA``),
the lr schedules, clip + AdamW, EMA, the velocity target, one microbatch's
loss and gradients and the full accumulated step against the JAX package, on
the CPU at tiny widths, also with ``remat`` on both sides; the port's
``remat`` against its own full-memory step. The JAX draws are made here
and injected. The data stream, checkpoints, ``run_training`` and the CLI
are in test_torch_training_loop.py."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import random_params
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse: one intra-op thread)

from audio_diffusion_torch.mel import Mel as TorchMel
from audio_diffusion_torch.models import UNet2D as TorchUNet
from audio_diffusion_torch.models import UNetConfig as TorchUNetConfig
from audio_diffusion_torch.models.ema import EMA as TorchEMA
from audio_diffusion_torch.ops import attention as at
from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline as TorchPipeline
from audio_diffusion_torch.schedulers import DDIMScheduler as TorchDDIM
from audio_diffusion_torch.schedulers import DDPMScheduler as TorchDDPM
from audio_diffusion_torch.schedulers import SchedulerConfig as TorchSchedulerConfig
from audio_diffusion_torch.training import train_unet as tt
from audio_diffusion_torch.utils.convert import to_torch, unet_state_dict
from audio_diffusion_tpu.models import UNet2D, UNetConfig
from audio_diffusion_tpu.models.ema import EMA
from audio_diffusion_tpu.models.vae import DiagonalGaussian
from audio_diffusion_tpu.ops import pallas_attention
from audio_diffusion_tpu.schedulers import DDIMScheduler, DDPMScheduler
from audio_diffusion_tpu.training import train_unet as jt

UNCOND_KW = dict(sample_size=(8, 8), block_out_channels=(8, 16), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                 up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=4)
COND_KW = dict(sample_size=(8, 8), block_out_channels=(8, 16),
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, norm_num_groups=4,
               attention_head_dim=2, cross_attention_dim=12)
RES = 16  # the tiny PNG dataset's slices


def _unet_pair(kw, seed=1, in_channels=1):
    kw = dict(kw, in_channels=in_channels, out_channels=in_channels)
    cfg = UNetConfig(**kw)
    unet = UNet2D(cfg)
    params = random_params(unet.init_params, seed)
    port = TorchUNet(TorchUNetConfig(**kw))
    port.load_state_dict(to_torch(unet_state_dict(params, cfg)), strict=True)
    return cfg, unet, params, port


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ----------------------------------------------------------------- attention VJP

@pytest.mark.parametrize("n", [1, 4, 16, 64])
def test_flash_mha_backward_matches_jax_vjp(n):
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.standard_normal((2, 3, n, 8)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(pallas_attention.flash_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = at.FlashMHA.backwards
    o = at.FlashMHA.apply(*leaves, at.attention_plain)
    o.backward(torch.from_numpy(g))
    assert at.FlashMHA.backwards == before + 1
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    for t, w in zip(leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_flash_mha_backward_follows_reference_rounding_in_bf16():
    """In bf16 the backward differentiates reference_attention's order (p cast
    to q's dtype before P V), not attention_plain's f32 P V."""
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(1, 2, 16, 8, generator=g).bfloat16() for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    at.FlashMHA.apply(*leaves, at.attention_plain).backward(dout)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(at.attention_reference(*ref), ref, dout)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)


def test_multi_head_attention_on_the_cpu_stays_plain_under_grad():
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    before = (at.flash_mha.launches, at.FlashMHA.backwards)
    at.multi_head_attention(q, q, q).sum().backward()
    assert q.grad is not None and (at.flash_mha.launches, at.FlashMHA.backwards) == before


# ------------------------------------------------------- schedules, optimizer, EMA

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_optax(schedule):
    for warm, total in ((10, 60), (0, 40)):
        cfg = dict(learning_rate=3e-4, lr_schedule=schedule, lr_warmup_steps=warm, total_steps=total)
        got, want = tt.make_lr_schedule(tt.TrainConfig(**cfg)), jt.make_lr_schedule(jt.TrainConfig(**cfg))
        for count in [*range(warm + 11), total - 1, total, total + 3]:
            w = float(want(jnp.int32(count)))
            assert abs(got(count) - w) <= 1e-7 * abs(w), (schedule, warm, count, got(count), w)
        if warm:
            assert got(0) == 0.0


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    ema_j, ema_t = EMA(), TorchEMA()
    for step in (0, 1, 2, 10, 1000, 10**7):
        assert abs(ema_t.decay(step) - float(ema_j.decay(step))) <= 1e-7
    e, p = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    want = ema_j.update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 7)["w"]
    te = torch.tensor(e)
    assert ema_t.update([te], [torch.tensor(p)], 7) == ema_t.decay(7)
    np.testing.assert_allclose(te.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_clip_and_adamw_match_optax_on_injected_gradients():
    """5 steps on the same gradient trees, two of them above the clip norm:
    params within 1e-6 (warmup, so the first update has lr 0)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3, 3), ()]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg = dict(learning_rate=1e-2, lr_warmup_steps=2, total_steps=20)
    opt = tt.make_optimizer(tt.TrainConfig(**cfg))
    params = {str(i): torch.tensor(x.copy()) for i, x in enumerate(p0)}
    state = opt.init(params)
    jopt = jt.make_optimizer(jt.TrainConfig(**cfg))
    jparams = [jnp.asarray(x) for x in p0]
    jstate = jopt.init(jparams)
    for i in range(5):
        grads = [(rng.standard_normal(s) * (2.0 if i % 2 else 0.1)).astype(np.float32) for s in shapes]
        opt.step(list(params.values()), [torch.tensor(g) for g in grads], state)
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, want in enumerate(jparams):
            np.testing.assert_allclose(params[str(k)].numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert state.count == 5


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_velocity_matches_jax(kind):
    rng = np.random.default_rng(1)
    x, n = (rng.standard_normal((3, 4, 4, 1)).astype(np.float32) for _ in range(2))
    t = np.array([0, 499, 999])
    jsched, tsched = (DDPMScheduler(), TorchDDPM()) if kind == "ddpm" else (DDIMScheduler(), TorchDDIM())
    want = jsched.velocity(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = tsched.velocity(torch.tensor(x), torch.tensor(n), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ------------------------------------------------------------- loss and step

CASES = {"unconditional": (UNCOND_KW, "epsilon", False), "conditional": (COND_KW, "epsilon", False),
         "cached_latents": (UNCOND_KW, "epsilon", True), "v_prediction": (UNCOND_KW, "v_prediction", False),
         "remat_unconditional": (dict(UNCOND_KW, remat=True), "epsilon", False),
         "remat_conditional": (dict(COND_KW, remat=True), "epsilon", False)}


def _jax_draws(key, micro, shape, t_max=1000):
    """train_unet.py:209-221: split(key, 3) -> timesteps, noise, posterior eps."""
    t_key, n_key, v_key = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(t_key, (micro,), 0, t_max)),
            np.asarray(jax.random.normal(n_key, (micro, *shape))),
            np.asarray(jax.random.normal(v_key, (micro, *shape))))


@pytest.mark.parametrize("case", list(CASES))
def test_microbatch_loss_and_gradients_match_jax(case):
    kw, prediction, cached = CASES[case]
    conditional = "cross_attention_dim" in kw
    cfg, unet, params, port = _unet_pair(kw, seed=2)
    rng = np.random.default_rng(3)
    micro = 3
    shape = (8, 8, 1)
    images = rng.uniform(-1, 1, (micro, *shape)).astype(np.float32)
    if cached:  # moments: mean ‖ logvar
        images = np.concatenate([images, rng.uniform(-3, 0, (micro, *shape)).astype(np.float32)], axis=-1)
    enc = rng.standard_normal((micro, 1, 12)).astype(np.float32) if conditional else None
    t, noise, eps = _jax_draws(jax.random.key(5), micro, shape)
    jsched = DDPMScheduler()

    def jax_loss(p):  # train_unet.py:208-228 with the draws injected
        clean = jnp.asarray(images)
        if cached:
            mean, logvar = jnp.split(clean, 2, axis=-1)
            d = DiagonalGaussian(mean, logvar)
            clean = jax.lax.stop_gradient(0.18215 * (d.mean + d.std * jnp.asarray(eps)))
        noisy = jsched.add_noise(clean, jnp.asarray(noise), jnp.asarray(t))
        pred = unet.apply({"params": p}, noisy, jnp.asarray(t), None if enc is None else jnp.asarray(enc))
        target = jsched.velocity(clean, jnp.asarray(noise), jnp.asarray(t)) if prediction == "v_prediction" else noise
        return jnp.mean((pred - target) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss_fn = tt.make_loss_fn(tt.TrainConfig(prediction_type=prediction), port, TorchDDPM(), conditional=conditional,
                              cached_latents=cached)
    loss = loss_fn(torch.tensor(images), None if enc is None else torch.tensor(enc), torch.tensor(t),
                   torch.tensor(noise), torch.tensor(eps) if cached else None)
    loss.backward()
    assert _rel(loss, want_loss) <= 1e-5
    want = unet_state_dict(want_grads, cfg)
    got = {k: p.grad for k, p in port.named_parameters()}
    assert got.keys() == want.keys() and all(g is not None for g in got.values())
    # to_k's bias gets a zero gradient in exact arithmetic (softmax ignores a
    # shift shared by every key): there both packages must give rounding
    # noise, under 1e-6 of the largest gradient.
    noise = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        if k.endswith("to_k.bias"):
            assert np.abs(g.numpy()).max() <= noise and np.abs(want[k]).max() <= noise, k
        else:
            assert np.abs(g.numpy() - want[k]).max() <= 1e-4 * np.abs(want[k]).max(), k


@pytest.mark.parametrize("kw", [UNCOND_KW, COND_KW], ids=["unconditional", "conditional"])
def test_remat_changes_no_gradient_and_runs_each_block_again(kw):
    """``remat=True`` against ``remat=False`` on the same weights: one train
    step's gradients and updated parameters bitwise equal; each
    ResnetBlock2D, SelfAttention2D and Transformer2D starts twice per
    microbatch under grad (the forward and the backward's recompute) and
    once under ``no_grad``; a tiny pipeline's images bitwise the same."""
    _, _, _, port = _unet_pair(kw, seed=10)
    conditional = "cross_attention_dim" in kw
    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (1, 3, 8, 8, 1)).astype(np.float32)
    enc = rng.standard_normal((1, 3, 1, 12)).astype(np.float32) if conditional else None
    draws = dict(timesteps=rng.integers(0, 1000, (1, 3)), noise=rng.standard_normal((1, 3, 8, 8, 1)))
    cfg = tt.TrainConfig(learning_rate=1e-3, lr_warmup_steps=0)
    out = {}
    for remat in (False, True):
        unet = TorchUNet(TorchUNetConfig(**dict(kw, remat=remat)))
        unet.load_state_dict(port.state_dict(), strict=True)
        starts = {}

        def count(module, args):
            starts[module] = starts.get(module, 0) + 1

        for m in unet.modules():
            if type(m).__name__ in ("ResnetBlock2D", "SelfAttention2D", "Transformer2D"):
                m.register_forward_pre_hook(count)
        state = tt.init_train_state(cfg, unet.train())
        _, metrics = tt.make_train_step(cfg, unet, TorchDDPM(), conditional=conditional)(state, images, enc, **draws)
        assert set(starts.values()) == {2 if remat else 1} and len(starts) == 12
        starts.clear()
        with torch.no_grad():
            unet(torch.from_numpy(images[0]), torch.tensor(500), None if enc is None else torch.from_numpy(enc[0]))
        assert set(starts.values()) == {1}
        pipe = TorchPipeline(unet.eval(), TorchMel(x_res=8, y_res=8, device="cpu"),
                             TorchDDIM(TorchSchedulerConfig(100)), device="cpu")
        raw = pipe(batch_size=2, steps=2, generator=torch.Generator().manual_seed(12), return_images_only=True,
                   encoding=None if enc is None else enc[0, :2, 0])
        out[remat] = (metrics["loss"], {k: p.grad for k, p in unet.named_parameters()},
                      {k: p.detach() for k, p in unet.named_parameters()}, raw)
    (loss0, grads0, params0, raw0), (loss1, grads1, params1, raw1) = out[False], out[True]
    assert torch.equal(loss0, loss1) and np.array_equal(raw0, raw1)
    assert all(torch.equal(grads0[k], grads1[k]) and torch.equal(params0[k], params1[k]) for k in grads0)


def test_train_step_with_accumulation_matches_jax():
    """accum 2 x micro 2 against make_train_step with the same key: loss,
    grad_norm and ema_decay at 1e-5 (the draws of each microbatch come from
    split(key, accum), then split(k, 3), as the JAX step makes them)."""
    cfg_kw = dict(learning_rate=1e-3, lr_warmup_steps=1, total_steps=100, gradient_accumulation_steps=2)
    _, unet, params, port = _unet_pair(UNCOND_KW, seed=4)
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (2, 2, 8, 8, 1)).astype(np.float32)
    key = jax.random.key(9)
    draws = [_jax_draws(k, 2, (8, 8, 1)) for k in jax.random.split(key, 2)]
    jstate = jt.init_train_state(jt.TrainConfig(**cfg_kw), params)
    jstep = jt.make_train_step(jt.TrainConfig(**cfg_kw), unet, DDPMScheduler())
    _, want = jstep(jstate, jnp.asarray(images), None, key)

    state = tt.init_train_state(tt.TrainConfig(**cfg_kw), port)
    step = tt.make_train_step(tt.TrainConfig(**cfg_kw), port, TorchDDPM())
    state, got = step(state, images, timesteps=np.stack([d[0] for d in draws]),
                      noise=np.stack([d[1] for d in draws]))
    assert state.step == 1 and state.opt_state.count == 1
    for name in ("loss", "grad_norm", "ema_decay"):
        assert _rel(got[name], want[name]) <= 1e-5, (name, float(got[name]), float(want[name]))


def test_accumulation_2x2_equals_one_batch_of_4():
    _, _, _, port = _unet_pair(UNCOND_KW, seed=6)
    rng = np.random.default_rng(7)
    images = rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32)
    t = rng.integers(0, 1000, 4)
    noise = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    out = {}
    for accum in (1, 2):
        unet = TorchUNet(port.config)
        unet.load_state_dict(port.state_dict())
        cfg = tt.TrainConfig(gradient_accumulation_steps=accum, use_ema=False)
        state = tt.init_train_state(cfg, unet)
        micro = 4 // accum
        _, m = tt.make_train_step(cfg, unet, TorchDDPM())(
            state, images.reshape(accum, micro, 8, 8, 1), timesteps=t.reshape(accum, micro),
            noise=noise.reshape(accum, micro, 8, 8, 1))
        out[accum] = m
    for name in ("loss", "grad_norm"):
        assert _rel(out[2][name], out[1][name]) <= 1e-5


def test_train_step_draws_from_the_seed_and_step_and_refuses_partial_draws():
    _, _, _, port = _unet_pair(UNCOND_KW, seed=8)
    images = np.random.default_rng(9).uniform(-1, 1, (1, 2, 8, 8, 1)).astype(np.float32)
    cfg = tt.TrainConfig(use_ema=False)
    losses = []
    for _ in range(2):
        unet = TorchUNet(port.config)
        unet.load_state_dict(port.state_dict())
        state = tt.init_train_state(cfg, unet)
        step = tt.make_train_step(cfg, unet, TorchDDPM())
        losses.append([float(step(state, images, seed=3)[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    with pytest.raises(ValueError, match="inject every draw"):
        step(state, images, timesteps=np.zeros((1, 2), np.int64))
    # without a process group both shardings are the one-device step, as on a one-device JAX mesh
    unet = TorchUNet(port.config)
    unet.load_state_dict(port.state_dict())
    fsdp = tt.TrainConfig(use_ema=False, param_sharding="fsdp")
    assert tt.wrap_unet(fsdp, unet) is unet
    step = tt.make_train_step(fsdp, unet, TorchDDPM())
    assert float(step(tt.init_train_state(fsdp, unet), images, seed=3)[1]["loss"]) == losses[0][0]
    with pytest.raises(ValueError, match="unknown param_sharding"):
        tt.wrap_unet(tt.TrainConfig(param_sharding="zero3"), unet)
