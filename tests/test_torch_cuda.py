"""Kernel-wrapper contracts of the port. This file imports no JAX, so the
GPU-marked tests run on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card those tests skip; the CPU dispatch tests run everywhere."""

import numpy as np
import pytest
import torch

from audio_diffusion_torch.ops import attention as at
from audio_diffusion_torch.ops import fused_groupnorm as gn

# One (shape, groups) per route of the GroupNorm+SiLU kernel; the slabs are
# whole 16-byte packs, so x is read with vector loads.
ROUTES = {
    "warp": ((4, 512, 4, 4), 32),  # 256 values per slab
    "block": ((4, 256, 16, 16), 32),  # 2,048
    "cluster": ((1, 128, 256, 256), 32),  # 262,144: the pixel-256 UNet's first level
    "reread": ((1, 32, 512, 512), 4),  # 2,097,152: too large for a 16-CTA cluster's shared memory
}
# Slabs that are not whole packs take scalar loads.
ODD = {"warp": ((3, 96, 5, 7), 32), "block": ((2, 64, 33, 33), 32), "cluster": ((1, 64, 129, 131), 32)}
# 16 CTAs of 51,200 f32 values each: every CTA at the shared-memory limit.
FULL_CLUSTER = ((1, 2, 640, 640), 1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _inputs(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda") * 3 + 1).to(dtype)
    return x, torch.randn(c, generator=g, device="cuda"), torch.randn(c, generator=g, device="cuda")


def _assert_close_to_plain(y, x, w, b, groups, eps=1e-5):
    """f32 within 1e-5 * max|y|; bf16 within one bf16 ulp of the f32 result
    (plus that f32 tolerance for values near 0)."""
    ref = gn.group_norm_silu_plain(x.float(), w, b, groups, eps)
    d = (y.float() - ref).abs()
    tol = 1e-5 * ref.abs().max().item()
    if y.dtype == torch.float32:
        assert d.max().item() <= tol
    else:
        _, e = torch.frexp(ref.abs().clamp(min=torch.finfo(torch.float32).tiny))
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)  # bf16 keeps 8 significant bits
        assert (d / (ulp + tol)).max().item() <= 1.0


def test_cpu_tensors_take_the_plain_version_and_never_count():
    before = (gn.group_norm_silu.launches, at.flash_mha.launches)
    x = torch.randn(2, 64, 4, 4)
    w = torch.ones(64)
    torch.testing.assert_close(gn.fused_group_norm_silu(x, w, w, 32, 1e-5),
                               gn.group_norm_silu_plain(x, w, w, 32, 1e-5), rtol=0, atol=0)
    q = torch.randn(1, 64, 4, 8)
    torch.testing.assert_close(at.multi_head_attention(q, q, q), at.attention_plain(q, q, q), rtol=0, atol=0)
    assert (gn.group_norm_silu.launches, at.flash_mha.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.randn(2, 64, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        gn.group_norm_silu(x, torch.ones(64), torch.ones(64), 32, 1e-5)
    q = torch.randn(1, 64, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        at.flash_mha(q, q, q)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_requires_grad():
    """The GroupNorm kernel and the raw flash_mha have no backward; under
    autograd multi_head_attention goes through FlashMHA instead."""
    _cuda()
    x = torch.randn(2, 64, 4, 4, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        gn.fused_group_norm_silu(x, w, torch.zeros_like(w), 32, 1e-5)
    q = torch.randn(1, 64, 4, 8, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        at.flash_mha(q, q, q)
    assert at.multi_head_attention(q, q, q).grad_fn is not None
    with torch.no_grad():
        assert gn.fused_group_norm_silu(x, w, torch.zeros_like(w), 32, 1e-5).shape == x.shape
        assert at.multi_head_attention(q, q, q).shape == q.shape


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_cannot_take():
    _cuda()
    x = torch.randn(2, 64, 4, 4, device="cuda")
    w = torch.ones(64, device="cuda")
    with pytest.raises(TypeError):
        gn.group_norm_silu(x.half(), w, w, 32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x.transpose(2, 3), w, w, 32)
    with pytest.raises(ValueError, match="f32"):
        gn.group_norm_silu(x, w.cpu(), w, 32)
    q = torch.randn(1, 4, 16, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        at.flash_mha(q, q, q)
    q = torch.randn(1, 4, 8, 16, device="cuda").transpose(2, 3)  # (1, 4, 16, 8), last stride 16
    with pytest.raises(ValueError, match="stride"):
        at.flash_mha(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_and_rows_do_not_depend_on_the_batch(dtype):
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 256, 16, 16, generator=g, device="cuda").to(dtype)
    w, b = torch.randn(256, generator=g, device="cuda"), torch.randn(256, generator=g, device="cuda")
    y = gn.fused_group_norm_silu(x, w, b, 32, 1e-5)
    ref = gn.group_norm_silu_plain(x, w, b, 32, 1e-5)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol * ref.float().abs().max().item())
    torch.testing.assert_close(gn.fused_group_norm_silu(x[:1].contiguous(), w, b, 32, 1e-5), y[:1], rtol=0, atol=0)
    q, k, v = (torch.randn(2, 64, 256, 8, generator=g, device="cuda").to(dtype) for _ in range(3))
    o = at.multi_head_attention(q, k, v)
    torch.testing.assert_close(o.float(), at.attention_plain(q.float(), k.float(), v.float()), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 1e-2)
    torch.testing.assert_close(at.multi_head_attention(q[:1].contiguous(), k[:1].contiguous(),
                                                       v[:1].contiguous()), o[:1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [*ROUTES, *("odd " + k for k in ODD), "full cluster"])
def test_every_route_matches_plain(case, dtype):
    _cuda()
    route = case.split()[-1]
    shape, groups = {"odd": ODD, "full": {"cluster": FULL_CLUSTER}}.get(case.split()[0], ROUTES)[route]
    assert gn.launch_plan(*shape[1:], groups, dtype).route == route
    x, w, b = _inputs(shape, dtype)
    for eps in (1e-5, 1e-6):
        y = gn.group_norm_silu(x, w, b, groups, eps)
        torch.cuda.synchronize()
        assert y.shape == x.shape and y.dtype == dtype
        _assert_close_to_plain(y, x, w, b, groups, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["warp", "block", "cluster"])
def test_row_is_bitwise_the_same_alone_and_in_batch_32(route, dtype):
    _cuda()
    shape, groups = ROUTES[route]
    x, w, b = _inputs((32, *shape[1:]), dtype, seed=1)
    y = gn.group_norm_silu(x, w, b, groups)
    torch.testing.assert_close(gn.group_norm_silu(x[:1].contiguous(), w, b, groups), y[:1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["warp", "block", "cluster"])
def test_unaligned_input_takes_scalar_loads_and_gives_the_same_bits(route):
    _cuda()
    shape, groups = ROUTES[route]
    x, w, b = _inputs(shape, torch.bfloat16, seed=2)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = flat[1:].view(shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    torch.testing.assert_close(gn.group_norm_silu(shifted, w, b, groups), gn.group_norm_silu(x, w, b, groups),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_one_call_is_one_launch():
    _cuda()
    for shape, groups in ROUTES.values():
        x, w, b = _inputs(shape, torch.bfloat16)
        before = gn.group_norm_silu.launches
        gn.fused_group_norm_silu(x, w, b, groups)
        assert gn.group_norm_silu.launches == before + 1


@pytest.mark.cuda
def test_graph_capture_replays_the_same_output():
    _cuda()
    cases = [(_inputs(shape, torch.bfloat16, seed=3), groups) for shape, groups in ROUTES.values()]
    eager = [gn.group_norm_silu(x, w, b, groups) for (x, w, b), groups in cases]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [gn.group_norm_silu(x, w, b, groups) for (x, w, b), groups in cases]
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for out, want in zip(outs, eager):
        torch.testing.assert_close(out, want, rtol=0, atol=0)


# Attention: (N, d) per case; the routes follow from attention.attention_plan.
# N=17, 255 and 1000 are ragged against the 16-row query tiles and 64-key
# blocks; N=2100 streams K and V through the mma route's two buffers.
ATTN_CASES = [(1, 8), (4, 8), (16, 8), (17, 8), (255, 8), (256, 8), (1000, 8), (2100, 8), (4, 32), (17, 32),
              (256, 128)]


def _heads(b, n, d, dtype, seed=0):
    """q, k, v as the UNet passes them: (B, N, heads, d) projections seen as (B, heads, N, d)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, n, 4, d), generator=g, device="cuda").to(dtype).transpose(1, 2) for _ in range(3)]


def _assert_attention_close(o, q, k, v):
    """f32 within 1e-5 * max|o|. bf16: the mma route rounds P to bf16 before
    P V, as reference_attention does (up to 2^-8 max|v|), then the result
    rounds once to bf16 (one ulp)."""
    ref = at.attention_plain(q.float(), k.float(), v.float())
    d = (o.float() - ref).abs()
    if o.dtype == torch.float32:
        assert d.max().item() <= 1e-5 * ref.abs().max().item()
    else:
        _, e = torch.frexp(ref.abs().clamp(min=torch.finfo(torch.float32).tiny))
        ulp = torch.ldexp(torch.ones_like(ref), e - 8)  # bf16 keeps 8 significant bits
        assert bool((d <= 2.0 ** -8 * v.float().abs().max().item() + ulp).all())


def test_attention_cases_cover_every_route():
    routes = {at.attention_plan(n, d, dtype).route for n, d in ATTN_CASES for dtype in (torch.float32, torch.bfloat16)}
    assert routes == {"small", "mma", "simt"}
    plan = at.attention_plan(2100, 8, torch.bfloat16)
    assert plan.route == "mma" and plan.chunk < 2100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, d", ATTN_CASES)
def test_attention_every_route_matches_plain(n, d, dtype):
    _cuda()
    q, k, v = _heads(1 if n > 1024 else 2, n, d, dtype)
    o = at.flash_mha(q, k, v)
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == dtype
    _assert_attention_close(o, q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_one_key_gives_v(dtype):
    _cuda()
    q, k, v = _heads(3, 1, 8, dtype)
    assert torch.equal(at.flash_mha(q, k, v), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 17, 256, 2100])
def test_attention_strided_and_unaligned_inputs_give_the_same_bits(n, dtype):
    _cuda()
    q, k, v = _heads(1, n, 8, dtype, seed=4)
    assert not q.is_contiguous()
    o = at.flash_mha(q, k, v)
    assert torch.equal(at.flash_mha(q.contiguous(), k.contiguous(), v.contiguous()), o)
    shifted = []
    for t in (q, k, v):  # one element past a 16-byte boundary: scalar loads
        flat = torch.empty(t.numel() + 1, dtype=dtype, device="cuda")
        s = flat[1:].view(t.shape)
        s.copy_(t)
        shifted.append(s)
    assert shifted[0].data_ptr() % 16
    assert torch.equal(at.flash_mha(*shifted), o)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 16, 256, 1000])
def test_attention_row_is_bitwise_the_same_alone_and_in_batch_32(n, dtype):
    _cuda()
    q, k, v = _heads(32, n, 8, dtype, seed=5)
    assert torch.equal(at.flash_mha(q[:1], k[:1], v[:1]), at.flash_mha(q, k, v)[:1])


@pytest.mark.cuda
def test_attention_is_one_launch_and_replays_from_a_graph():
    _cuda()
    cases = [_heads(2, n, 8, dtype, seed=6) for n in (4, 256) for dtype in (torch.float32, torch.bfloat16)]
    before = at.flash_mha.launches
    eager = [at.flash_mha(*qkv) for qkv in cases]
    assert at.flash_mha.launches == before + len(cases)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [at.flash_mha(*qkv) for qkv in cases]
    for out in outs:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for out, want in zip(outs, eager):
        assert torch.equal(out, want)


# ------------------------------------------------------------------ serving path

@pytest.mark.cuda
def test_per_row_step_noise_on_the_card_is_independent_of_the_co_batch():
    _cuda()
    from audio_diffusion_torch.schedulers.common import step_noises

    def gens(seeds):
        return [torch.Generator(device="cuda").manual_seed(s) for s in seeds]

    shape = (3, 32, 32, 1)
    alone = list(step_noises((1, *shape[1:]), 50, torch.device("cuda"), gens([7])))
    batched = list(step_noises(shape, 50, torch.device("cuda"), gens([3, 7, 11])))
    assert all(a.is_cuda and torch.equal(a[0], b[1]) for a, b in zip(alone, batched))
    assert not torch.equal(batched[0][0], batched[0][1])


@pytest.mark.cuda
def test_side_stream_host_copy_equals_a_synchronous_copy():
    """The finisher's copy waits for the work queued before it on the current
    stream and gives what a synchronous .cpu() of the same tensors gives."""
    _cuda()
    from audio_diffusion_torch.serving.batcher import copy_to_host_async

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2048, 2048, generator=g, device="cuda")
    for _ in range(20):  # long enough that an unordered copy would read stale values
        x = torch.tanh(x @ x * 1e-3)
    raw = (x[:32, :256] * 100).to(torch.uint8)
    pcm = (x[:32] * 30000).to(torch.int16)
    stream = torch.cuda.Stream()
    hosts, (start, done) = copy_to_host_async((raw, pcm), stream)
    assert all(h.is_pinned() for h in hosts)
    done.synchronize()
    assert start.elapsed_time(done) >= 0
    assert torch.equal(hosts[0], raw.cpu()) and torch.equal(hosts[1], pcm.cpu())


@pytest.mark.cuda
def test_from_pretrained_on_the_card_takes_the_kernels(tmp_path):
    """A port-saved directory loads on the card; fused_groupnorm=True (which
    the diffusers config does not carry) routes every ResnetBlock2D norm
    through the GroupNorm+SiLU kernel, and the attention block takes flash_mha."""
    _cuda()
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.models.unet2d import ResnetBlock2D, SelfAttention2D
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    cfg = UNetConfig(sample_size=(16, 16), block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                     "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                     norm_num_groups=8)
    cpu = AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(0)),
                                 Mel(x_res=16, y_res=16, device="cpu"), DDIMScheduler(), device="cpu")
    cpu.save_pretrained(str(tmp_path))
    n_res = sum(isinstance(m, ResnetBlock2D) for m in cpu.unet.modules())
    n_attn = sum(isinstance(m, SelfAttention2D) for m in cpu.unet.modules())
    for fused, want_gn in ((None, 0), (True, 2 * n_res * 2)):  # two norms per resnet, two steps
        pipe = AudioDiffusionPipeline.from_pretrained(str(tmp_path), fused_groupnorm=fused, device="cuda")
        before = (gn.group_norm_silu.launches, at.flash_mha.launches)
        raw, audio = pipe(batch_size=2, steps=2, return_arrays=True, pcm16=True)
        torch.cuda.synchronize()
        assert raw.is_cuda and raw.shape == (2, 16, 16) and audio.dtype == torch.int16
        assert gn.group_norm_silu.launches - before[0] == want_gn
        assert at.flash_mha.launches - before[1] == n_attn * 2


@pytest.mark.cuda
def test_conditional_unet_on_the_card_takes_the_groupnorm_kernel():
    """A small conditional UNet (f32, TF32 off) on the card: the GroupNorm+SiLU
    kernel on every ResnetBlock2D norm and SDPA in CrossAttention, within
    1e-4 of the same weights on the CPU (plain versions); no attention-kernel launch."""
    _cuda()
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.models.unet2d import ResnetBlock2D

    cfg = UNetConfig(sample_size=(32, 32), block_out_channels=(32, 64),
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1, norm_num_groups=8,
                     attention_head_dim=4, cross_attention_dim=24, fused_groupnorm=True)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    x, enc = torch.randn(2, 32, 32, 1, generator=g), torch.randn(2, 3, 24, generator=g)
    t = torch.tensor([999, 10])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = unet(x, t, enc)
            before = (gn.group_norm_silu.launches, at.flash_mha.launches)
            out = unet.to("cuda")(x.cuda(), t.cuda(), enc.cuda())
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    n_res = sum(isinstance(m, ResnetBlock2D) for m in unet.modules())
    assert (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]) == (2 * n_res, 0)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-4 * max(1.0, ref.abs().max().item()))


# ------------------------------------------------------------------ training path

# (B, heads, N, d, dtype) per route of the attention plan under FlashMHA
GRAD_CASES = [(4, 64, 4, 8, torch.float32), (4, 64, 1, 8, torch.bfloat16), (2, 64, 256, 8, torch.bfloat16),
              (2, 8, 64, 64, torch.float32)]


def test_grad_cases_cover_every_route():
    assert {at.attention_plan(n, d, dt).route for _, _, n, d, dt in GRAD_CASES} == {"small", "mma", "simt"}


@pytest.mark.cuda
@pytest.mark.parametrize("b, h, n, d, dtype", GRAD_CASES)
def test_flash_mha_gradients_match_autograd_of_the_reference(b, h, n, d, dtype):
    """FlashMHA's forward is flash_mha's, bitwise; its backward is autograd
    through attention_reference on the saved inputs, so its gradients equal
    that autograd bitwise, in the inputs' shapes and dtype."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(n)
    qkv = [torch.randn((b, n, h, d), generator=g, device="cuda").to(dtype).transpose(1, 2) for _ in range(3)]
    dout = torch.randn((b, h, n, d), generator=g, device="cuda").to(dtype)
    leaves = [t.detach().clone().requires_grad_(True) for t in qkv]
    before = (at.flash_mha.launches, at.FlashMHA.backwards)
    o = at.FlashMHA.apply(*leaves)
    o.backward(dout)
    torch.cuda.synchronize()
    assert (at.flash_mha.launches, at.FlashMHA.backwards) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        assert torch.equal(o, at.flash_mha(*qkv))
    ref = [t.detach().clone().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(at.attention_reference(*ref), ref, dout)
    for t, w in zip(leaves, want):
        assert t.grad.shape == t.shape and t.grad.dtype == dtype and torch.equal(t.grad, w)


@pytest.mark.cuda
def test_one_bf16_train_step_of_a_tiny_unet_on_the_card():
    """A tiny bf16 UNet with an attention level takes one optimizer step on
    the card: one flash_mha launch and one FlashMHA backward per attention
    layer and microbatch, no GroupNorm-kernel launch, every parameter gets a
    gradient, finite loss."""
    _cuda()
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.models.unet2d import SelfAttention2D
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training.train_unet import TrainConfig, init_train_state, make_train_step

    cfg = UNetConfig(sample_size=(16, 16), block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                     "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                     norm_num_groups=8, dtype="bfloat16")
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0)).to("cuda")
    n_attn = sum(isinstance(m, SelfAttention2D) for m in unet.modules())
    tc = TrainConfig(gradient_accumulation_steps=2, lr_warmup_steps=0)
    state = init_train_state(tc, unet)
    step = make_train_step(tc, unet, DDPMScheduler())
    images = torch.rand((2, 4, 16, 16, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    before = (at.flash_mha.launches, at.FlashMHA.backwards, gn.group_norm_silu.launches)
    state, metrics = step(state, images, seed=0)
    torch.cuda.synchronize()
    assert (at.flash_mha.launches - before[0], at.FlashMHA.backwards - before[1],
            gn.group_norm_silu.launches - before[2]) == (2 * n_attn, 2 * n_attn, 0)
    assert all(p.grad is not None for p in unet.parameters())
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0


# --------------------------------------------------------- convenience layer

def _tiny_saved_pipeline(path):
    """A tiny latent-free pipeline with an attention level, saved in the
    diffusers layout; returns its ResnetBlock2D and SelfAttention2D counts."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.models.unet2d import ResnetBlock2D, SelfAttention2D
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    cfg = UNetConfig(sample_size=(16, 16), block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                     "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                     norm_num_groups=8)
    cpu = AudioDiffusionPipeline(UNet2D(cfg).init_params(torch.Generator().manual_seed(0)),
                                 Mel(x_res=16, y_res=16, device="cpu"), DDIMScheduler(), device="cpu")
    cpu.save_pretrained(path)
    return (sum(isinstance(m, ResnetBlock2D) for m in cpu.unet.modules()),
            sum(isinstance(m, SelfAttention2D) for m in cpu.unet.modules()))


@pytest.mark.cuda
def test_audio_diffusion_on_the_card_takes_both_kernels(tmp_path):
    """AudioDiffusion(..., fused_groupnorm=True) on the card: every denoise
    step of a generation and of an audio-to-audio call with a mask launches
    the GroupNorm+SiLU kernel on every ResnetBlock2D norm and flash_mha once
    per attention layer."""
    _cuda()
    from audio_diffusion_torch.audio_diffusion import AudioDiffusion

    n_res, n_attn = _tiny_saved_pipeline(str(tmp_path))
    ad = AudioDiffusion(str(tmp_path), fused_groupnorm=True, device="cuda")
    clip = torch.randn(16 * 512, generator=torch.Generator().manual_seed(2)).numpy() * 0.3
    for call, steps in ((lambda g: ad.generate_spectrogram_and_audio(steps=3, generator=g), 3),
                        (lambda g: ad.generate_spectrogram_and_audio_from_audio(
                            raw_audio=clip, start_step=1, steps=3, mask_start_secs=0.1, generator=g), 2)):
        before = (gn.group_norm_silu.launches, at.flash_mha.launches)
        image, (sr, audio) = call(torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        assert (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]) == \
            (2 * n_res * steps, n_attn * steps)
        assert image.size == (16, 16) and sr == 22050 and audio.shape == (15 * 512,)
        assert torch.isfinite(torch.from_numpy(audio)).all()


@pytest.mark.cuda
def test_stitch_on_the_card_stays_on_the_device(tmp_path):
    """outpaint, serial remix and parallel remix on a CUDA pipeline: every
    call's generator and noise live on the card, every denoise step goes
    through both kernels, and the parallel remix is one call of one row per
    window."""
    _cuda()
    from audio_diffusion_torch.pipelines import stitch
    from audio_diffusion_torch.pipelines.pipeline import AudioDiffusionPipeline

    n_res, n_attn = _tiny_saved_pipeline(str(tmp_path))
    pipe = AudioDiffusionPipeline.from_pretrained(str(tmp_path), fused_groupnorm=True, device="cuda")
    calls = []

    class OnTheCard:
        mel, sample_hw, unet, device = pipe.mel, pipe.sample_hw, pipe.unet, pipe.device

        def __call__(self, **kw):
            for name in ("generator", "step_generator", "noise"):
                if kw.get(name) is not None:
                    assert kw[name].device.type == "cuda", name
            calls.append(np.asarray(kw["raw_audio"]).shape)
            return pipe(**kw)

    track = torch.randn(3 * 16 * 512, generator=torch.Generator().manual_seed(3)).numpy() * 0.3
    n_windows = len(track) // (16 * 512 - int(0.1 * 22050))
    # (run, calls, denoise steps per call): outpaint from noise, the remixes from start_step 1 of 2
    for run, n_calls, steps in ((lambda: stitch.outpaint(OnTheCard(), track[:9000], 2, overlap_secs=0.1, steps=2),
                                 2, 2),
                                (lambda: stitch.remix(OnTheCard(), track, start_step=1, overlap_secs=0.1, steps=2),
                                 n_windows, 1),
                                (lambda: stitch.remix(OnTheCard(), track, start_step=1, overlap_secs=0.1, steps=2,
                                                      parallel=True), 1, 1)):
        calls.clear()
        before = (gn.group_norm_silu.launches, at.flash_mha.launches)
        out = run()
        torch.cuda.synchronize()
        assert len(calls) == n_calls and np.isfinite(out).all()
        assert (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]) == \
            (2 * n_res * steps * n_calls, n_attn * steps * n_calls)
    assert calls == [(n_windows, 16 * 512)]
