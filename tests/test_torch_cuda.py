"""Kernel-wrapper contracts of the port. This file imports no JAX, so the
GPU-marked tests run on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card those tests skip; the CPU dispatch tests run everywhere."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    if y.dtype == torch.float32:
        assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    else:
        _assert_within_a_bf16_ulp(y, ref)


def _assert_within_a_bf16_ulp(y, ref):
    """bf16 y within one bf16 ulp of the f32 ref, plus 1e-5 * max|ref| for
    values near 0."""
    d = (y.float() - ref).abs()
    tol = 1e-5 * ref.abs().max().item()
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
        runs = 1 + len(pipe._compiled)  # the first call captures its program after an eager warm-up
        assert runs == 2
        assert gn.group_norm_silu.launches - before[0] == want_gn * runs
        assert at.flash_mha.launches - before[1] == n_attn * 2 * runs


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
        before, n_programs = (gn.group_norm_silu.launches, at.flash_mha.launches), len(ad.pipe._compiled)
        image, (sr, audio) = call(torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        runs = 1 + len(ad.pipe._compiled) - n_programs  # a call that captures runs its steps once more, eagerly
        assert (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]) == \
            (2 * n_res * steps * runs, n_attn * steps * runs)
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
        before, n_programs = (gn.group_norm_silu.launches, at.flash_mha.launches), len(pipe._compiled)
        out = run()
        torch.cuda.synchronize()
        assert len(calls) == n_calls and np.isfinite(out).all()
        runs = n_calls + len(pipe._compiled) - n_programs  # a capture's eager warm-up runs the steps once more
        assert (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]) == \
            (2 * n_res * steps * runs, n_attn * steps * runs)
    assert calls == [(n_windows, 16 * 512)]


@pytest.mark.cuda
def test_nccl_world_one_ddp_step_equals_the_plain_step(tmp_path):
    """DDP over a one-rank NCCL group on the card: the averaged gradient is
    the rank's own, so the step (flash_mha forward and FlashMHA backward
    inside the wrapped UNet, accumulation 2) gives the plain step's bits."""
    _cuda()
    import torch.distributed as dist

    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.parallel import init_distributed
    from audio_diffusion_torch.schedulers import DDPMScheduler
    from audio_diffusion_torch.training import train_unet as tt

    kw = dict(sample_size=(8, 8), block_out_channels=(32, 64), down_block_types=("DownBlock2D", "AttnDownBlock2D"),
              up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=8,
              attention_head_dim=8)
    base = UNet2D(UNetConfig(**kw)).init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    images = torch.rand((2, 4, 8, 8, 1), generator=g) * 2 - 1
    draws = dict(timesteps=torch.randint(0, 1000, (2, 4), generator=g),
                 noise=torch.randn((2, 4, 8, 8, 1), generator=g))
    cfg = tt.TrainConfig(learning_rate=1e-3, lr_warmup_steps=0, total_steps=10, gradient_accumulation_steps=2)
    out = []
    assert init_distributed(f"file://{tmp_path}/rendezvous", 1, 0, device="cuda:0") == 0
    try:
        for wrap in (False, True):
            unet = UNet2D(UNetConfig(**kw))
            unet.load_state_dict(base.state_dict())
            unet = unet.to("cuda").train()
            model = tt.wrap_unet(cfg, unet) if wrap else unet
            assert isinstance(model, torch.nn.parallel.DistributedDataParallel) == wrap
            state = tt.init_train_state(cfg, model)
            before = (at.flash_mha.launches, at.FlashMHA.backwards)
            state, metrics = tt.make_train_step(cfg, model, DDPMScheduler())(state, images, **draws)
            torch.cuda.synchronize()
            assert at.flash_mha.launches > before[0] and at.FlashMHA.backwards > before[1]
            out.append((metrics["loss"], {k: p.detach().clone() for k, p in state.params.items()}))
    finally:
        dist.destroy_process_group()
    (loss_plain, plain), (loss_ddp, ddp) = out
    assert torch.equal(loss_plain, loss_ddp)
    assert all(torch.equal(plain[k], ddp[k]) for k in plain)


# ------------------------------------------------ the fused path: one CUDA graph per request signature

def _tiny_fused_pipeline():
    """The pipeline of _tiny_saved_pipeline on the card, with the GroupNorm+SiLU kernel."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    cfg = UNetConfig(sample_size=(16, 16), block_out_channels=(32, 64), down_block_types=("DownBlock2D",
                     "AttnDownBlock2D"), up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                     norm_num_groups=8, fused_groupnorm=True)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0))
    return AudioDiffusionPipeline(unet, Mel(x_res=16, y_res=16, device="cuda"), DDIMScheduler(), device="cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_graph_replay_is_bitwise_the_eager_request(eta):
    """A replayed request gives the eager request's spectrograms and int16
    audio bit for bit, and the launches credited to the counters per replay
    are the eager call's launches."""
    _cuda()
    pipe = _tiny_fused_pipeline()

    def run(fuse):
        before = (gn.group_norm_silu.launches, at.flash_mha.launches)
        with contextlib.nullcontext() if fuse else pipe._uncaptured():
            out = pipe(batch_size=2, steps=3, eta=eta, generator=_gen(1), step_generator=[_gen(2), _gen(3)],
                       return_arrays=True, pcm16=True)
        torch.cuda.synchronize()
        return out, (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1])

    run(True)  # captures the program
    (prog,) = pipe._compiled.values()
    (eager_raw, eager_audio), eager_launches = run(False)
    (raw, audio), launches = run(True)
    assert torch.equal(raw, eager_raw) and torch.equal(audio, eager_audio)
    assert launches == eager_launches and eager_launches[0] > 0 and eager_launches[1] > 0
    assert tuple(prog.launches[0]) == (*eager_launches, 0)  # outside the batcher's window: no convolution kernel


@pytest.fixture
def card():
    """The card, or a skip where torch sees none (decided here, never at import)."""
    _cuda()
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_traced_replay_shows_each_stage_mark_once_in_order(card):
    """A profiled replay of a fused b1 request shows adt_stage_mark<0..3>
    once each, in order, on the card's timeline."""
    import re

    from torch.profiler import ProfilerActivity, profile

    pipe = _tiny_fused_pipeline()
    pipe(batch_size=1, steps=3, return_arrays=True)  # captures the program
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(batch_size=1, steps=3, return_arrays=True)
        torch.cuda.synchronize()
    marks = sorted((e.start_ns(), int(m.group(1))) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and (m := re.search(r"\badt_stage_mark<(\d)>", e.name())))
    assert [k for _, k in marks] == [0, 1, 2, 3], marks


@pytest.mark.cuda
def test_a_thread_started_before_the_profiler_records_its_spans(card):
    import threading

    from torch.profiler import ProfilerActivity, profile

    from audio_diffusion_torch.utils import profiling

    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(60)
        with profiling.span("adt.test.worker", batch=5):
            torch.ones(8, device=card).sum().item()
        done.set()

    thread = threading.Thread(target=worker, name="adt-test-worker")
    thread.start()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        go.set()
        assert done.wait(60)
    thread.join(60)
    assert not thread.is_alive()
    mine = [s for s in profiling.spans() if s.name == "adt.test.worker"]
    assert mine and mine[-1].thread == "adt-test-worker" and mine[-1].ids == {"batch": 5}


@pytest.mark.cuda
def test_spans_share_the_profilers_clock(card):
    """On the profiler's thread, a span around a record_function begins and
    ends within 100 µs of it: time.time_ns and kineto share one clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from audio_diffusion_torch.utils import profiling

    x = torch.ones(1024, device=card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("adt.test.warm"):  # a first annotation costs more
            x.mul(2.0)
        with profiling.span("adt.test.outer"):
            with record_function("adt.test.inner"):
                x.mul(3.0)
        torch.cuda.synchronize()
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "adt.test.inner"
                and e.device_type() != torch.autograd.DeviceType.CUDA]
    outer = [s for s in profiling.spans() if s.name == "adt.test.outer"][-1]
    assert abs(inner.start_ns() - outer.t0_ns) < 100_000
    assert abs(outer.t1_ns - (inner.start_ns() + inner.duration_ns())) < 100_000


@pytest.mark.cuda
def test_a_served_batch_times_its_device_work(card):
    """device_ms (CUDA events around the pipeline call) is positive and no
    larger than the batch's run_s, which also waits for the copy and the delivery."""
    from audio_diffusion_torch.serving import DynamicBatcher

    batcher = DynamicBatcher(_tiny_fused_pipeline(), max_batch=2, max_wait_ms=200, steps=3)
    try:
        batcher.warmup()
        for f in [batcher.submit(seed=s) for s in range(2)]:
            f.result(timeout=300)
    finally:
        batcher.close()
    assert batcher.stats
    for s in batcher.stats:
        assert 0 < s["device_ms"] <= 1e3 * s["run_s"] and len(s["wait_ms"]) == s["n"]


def _full_width_f32_pipeline():
    """The latent-256 pipeline at full width (the 6-block UNet over 32x32
    latents, the 256 VAE, Mel 256x256 hop 512) in f32, seeded random weights."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, VAEConfig, unconditional_config
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    vae = AutoencoderKL(VAEConfig(sample_size=256)).init_params(torch.Generator().manual_seed(1))
    unet = UNet2D(unconditional_config(sample_size=(32, 32), fused_groupnorm=True)).init_params(
        torch.Generator().manual_seed(0))
    return AudioDiffusionPipeline(unet, Mel(x_res=256, y_res=256, hop_length=512, device="cuda"), DDIMScheduler(),
                                  vae, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["SelfAttention2D", "Transformer2D", "VAEAttention"])
def test_f32_attention_block_rows_do_not_depend_on_the_batch(block):
    """Each attention block at its widths on the latent-256 and conditional
    paths, f32 with TF32 off: row 0 alone and in batches of 2 to 33 (across
    whole and partial row blocks) gives the same bits."""
    _cuda()
    from audio_diffusion_torch.models import unet2d
    from audio_diffusion_torch.models.vae import VAEAttention

    make, shape, context = {
        "SelfAttention2D": (lambda: unet2d.SelfAttention2D(512, 8, 32), (512, 2, 2), None),
        "Transformer2D": (lambda: unet2d.Transformer2D(512, 8, 64, 100, 32), (512, 8, 8), (1, 100)),
        "VAEAttention": (lambda: VAEAttention(512, 32), (512, 32, 32), None)}[block]
    module = make()
    unet2d.init_flax_defaults(module, torch.Generator().manual_seed(0))
    module = module.to("cuda").eval()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((33, *shape), generator=g, device="cuda")
    args = (x,) if context is None else (x, torch.randn((33, *context), generator=g, device="cuda"))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            alone = module(*(a[:1] for a in args))
            for b in (2, 7, 8, 9, 16, 32, 33):
                assert torch.equal(module(*(a[:b] for a in args))[:1], alone), b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_full_width_f32_request_is_bitwise_the_same_alone_and_in_a_batch_of_8():
    """The serving contract in f32 on the card: through DynamicBatcher, 50
    DDIM steps at eta 0, TF32 off, seed 7 alone (tier 1) and among 7 other
    requests (tier 8) gives one spectrogram, bit for bit."""
    _cuda()
    from audio_diffusion_torch.serving import DynamicBatcher

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    batcher = DynamicBatcher(_full_width_f32_pipeline(), max_batch=8, max_wait_ms=2000, steps=50)
    try:
        solo = batcher.submit(seed=7).result(timeout=600)
        futs = [batcher.submit(seed=s) for s in (7, *range(100, 107))]
        batched = [f.result(timeout=600) for f in futs]
    finally:
        batcher.close()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert [(s["n"], s["tier"]) for s in batcher.stats] == [(1, 1), (8, 8)]
    assert solo.image.shape == (256, 256) and solo.image.std() > 0
    np.testing.assert_array_equal(solo.image, batched[0].image)
    assert not np.array_equal(batched[0].image, batched[1].image)


@pytest.mark.cuda
def test_a_stopped_server_frees_its_device_memory_without_the_collector():
    """A server that captured a program on the card and was stopped: once the
    caller drops it, its pipeline, CUDA graph and graph pool are freed by
    reference counting, with the cycle collector off."""
    _cuda()
    import gc
    import weakref

    from audio_diffusion_torch.serving import AudioDiffusionServer

    gc.collect()
    gc.disable()
    try:
        pipe = _tiny_fused_pipeline()
        alive = weakref.ref(pipe)
        server = AudioDiffusionServer(pipe, port=0, max_batch=2, max_wait_ms=10, steps=2)
        assert server.batcher.submit(seed=1).result(timeout=300).image.shape == (16, 16)
        assert next(iter(pipe._compiled.values())).graphs
        server.stop()
        del server, pipe
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
        assert alive() is None
    finally:
        gc.enable()
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() == held  # the collector had nothing of it left to free


@pytest.mark.cuda
def test_one_capture_per_signature_and_outputs_outlive_the_next_replay():
    _cuda()
    pipe = _tiny_fused_pipeline()
    first = pipe(batch_size=2, steps=2, generator=_gen(1), return_arrays=True)
    (prog,) = pipe._compiled.values()
    graphs, kept = prog.graphs, [t.clone() for t in first]
    second = pipe(batch_size=2, steps=2, generator=_gen(2), return_arrays=True)
    assert len(pipe._compiled) == 1 and prog.graphs is graphs  # a repeated signature replays
    pipe(batch_size=2, steps=3, generator=_gen(3), return_arrays=True)
    assert len(pipe._compiled) == 2  # another signature captures
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, kept)) and not torch.equal(first[0], second[0])
    assert prog.capture_seconds > 0 and prog.pool_bytes >= 0


@pytest.mark.cuda
def test_capture_beside_another_thread_copying_to_the_host():
    """A capture (capture_error_mode="thread_local") while another thread
    does what the batcher's finisher does: pinned host buffers, copies on a
    side stream, event waits. Neither fails, and the graph's request is
    bitwise the eager one."""
    _cuda()
    import threading

    from audio_diffusion_torch.serving.batcher import copy_to_host_async

    pipe = _tiny_fused_pipeline()
    stream, src = torch.cuda.Stream(), torch.randn(1 << 20, device="cuda")
    stop, errors, copies = threading.Event(), [], []

    def copier():
        try:
            while not stop.is_set():
                hosts, (_, done) = copy_to_host_async([src], stream)
                done.synchronize()
                copies.append(hosts[0][:1].item())
        except Exception as e:  # the test's assertion reports it
            errors.append(e)

    thread = threading.Thread(target=copier)
    thread.start()
    try:
        graph = pipe(batch_size=2, steps=3, generator=_gen(1), return_arrays=True)  # warm-up, capture, replay
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors and copies and len(pipe._compiled) == 1
    with pipe._uncaptured():
        eager = pipe(batch_size=2, steps=3, generator=_gen(1), return_arrays=True)
    assert all(torch.equal(a, b) for a, b in zip(graph, eager))


FAILING_CAPTURE = """
import sys
sys.path.insert(0, "tests")
from test_torch_cuda import _tiny_fused_pipeline
pipe = _tiny_fused_pipeline()


def host_read(module, args):  # reads a value on the host: no graph can hold that
    args[0].sum().item()


pipe.unet.register_forward_pre_hook(host_read)
try:
    pipe(batch_size=1, steps=2, return_arrays=True)
except RuntimeError as e:
    print("raised", pipe._compiled == {}, type(e).__name__)
else:
    print("returned")
"""


@pytest.mark.cuda
def test_a_failed_capture_raises_and_caches_nothing():
    """No eager fallback: a program that cannot be captured raises. In a
    process of its own, since a failed capture may leave the CUDA context
    unusable for what follows."""
    _cuda()
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", FAILING_CAPTURE], cwd=repo, capture_output=True, text=True,
                         timeout=600)
    assert "raised True" in out.stdout, out.stdout + out.stderr[-3000:]


# ------------------------------------- the staged path and encode: one CUDA graph per stage signature

def _tiny_latent_pipeline():
    """A tiny latent pipeline on the card: the VAE, an attention level in the
    UNet, the GroupNorm+SiLU kernel, Mel 16x16."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, UNetConfig, VAEConfig
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    vae = AutoencoderKL(VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
                                  sample_size=16)).init_params(torch.Generator().manual_seed(1))
    cfg = UNetConfig(sample_size=vae.config.latent_hw(16, 16), block_out_channels=(32, 64),
                     down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                     up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1, norm_num_groups=8,
                     fused_groupnorm=True)
    unet = UNet2D(cfg).init_params(torch.Generator().manual_seed(0))
    return AudioDiffusionPipeline(unet, Mel(x_res=16, y_res=16, device="cuda"), DDIMScheduler(), vae, device="cuda")


def _clips(seed, rows):
    return np.random.default_rng(seed).standard_normal((rows, 16 * 512)).astype(np.float32) * 0.3


def _staged_and_uncaptured(pipe, make):
    """``make()``'s request staged (capturing on its first signature) and
    uncaptured, each with the kernels' launches it counted."""
    out = {}
    for name in ("staged", "uncaptured"):
        before = (gn.group_norm_silu.launches, at.flash_mha.launches)
        pipe.fuse = False
        try:
            with pipe._uncaptured() if name == "uncaptured" else contextlib.nullcontext():
                result = pipe(return_arrays=True, **make())
        finally:
            pipe.fuse = True
        torch.cuda.synchronize()
        out[name] = (result, (gn.group_norm_silu.launches - before[0], at.flash_mha.launches - before[1]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch, clips", [(1, "batched"), (8, "batched"), (8, "single")])
def test_staged_replay_is_bitwise_the_uncaptured_request(batch, clips):
    """fuse=False replays one graph per stage (prep, denoise, decode, audio):
    spectrograms and int16 audio bitwise the uncaptured request's, the
    spectrograms bitwise the fused program's, and one replay credits the
    uncaptured request's launches; audio-to-audio from a clip per row and
    from one clip broadcast over the batch (a posterior sample)."""
    _cuda()
    pipe = _tiny_latent_pipeline()

    def make():
        raw_audio = _clips(batch, batch) if clips == "batched" else _clips(batch, 1)[0]
        return dict(batch_size=batch, raw_audio=raw_audio, start_step=1, steps=4, eta=0.5,
                    generator=_gen(1), step_generator=[_gen(10 + i) for i in range(batch)], mask_start_secs=0.05,
                    pcm16=True)

    _staged_and_uncaptured(pipe, make)  # captures the stages
    assert [k[0] for k in pipe._compiled] == ["prep", "denoise", "vae_decode", "audio"]
    assert all(p.graphs for p in pipe._compiled.values())
    runs = _staged_and_uncaptured(pipe, make)
    (staged, launches), (eager, eager_launches) = runs["staged"], runs["uncaptured"]
    assert all(torch.equal(a, b) for a, b in zip(staged, eager))
    assert launches == eager_launches and launches[0] > 0 and launches[1] > 0
    fused = pipe(return_arrays=True, **make())
    assert torch.equal(fused[0], staged[0])


@pytest.mark.cuda
def test_stochastic_staged_request_in_segments_replays_bitwise(monkeypatch):
    """A denoise stage over STEP_NOISE_BYTES is several graphs, each
    segment's step noise copied in just before its replay."""
    _cuda()
    from audio_diffusion_torch.pipelines import pipeline as pipeline_module

    pipe = _tiny_latent_pipeline()
    monkeypatch.setattr(pipeline_module, "STEP_NOISE_BYTES", 2 * 2 * 8 * 8 * 4)  # two steps of batch 2

    def make():
        return dict(batch_size=2, steps=5, eta=1.0, generator=_gen(2), step_generator=_gen(3))

    _staged_and_uncaptured(pipe, make)
    (denoise,) = [p for k, p in pipe._compiled.items() if k[0] == "denoise"]
    assert denoise.segments == [(0, 2), (2, 4), (4, 5)] and len(denoise.graphs) == 3
    runs = _staged_and_uncaptured(pipe, make)
    assert all(torch.equal(a, b) for a, b in zip(runs["staged"][0], runs["uncaptured"][0]))


@pytest.mark.cuda
def test_a_second_staged_request_with_the_same_key_gives_its_own_result():
    """The re-noised input, the mask's columns, the noise, the step noise and
    the phase are the stage graphs' inputs: a second request with the same
    signature and other data replays the same graphs and gives its own
    (uncaptured) result, and the first request's outputs outlive it."""
    _cuda()
    pipe = _tiny_latent_pipeline()

    def make(seed):
        return lambda: dict(batch_size=2, raw_audio=_clips(seed, 2), start_step=2, steps=4,
                            generator=_gen(seed), mask_start_secs=0.05, mask_end_secs=0.05)

    first = _staged_and_uncaptured(pipe, make(1))["staged"][0]
    kept = [t.clone() for t in first]
    graphs = {k: p.graphs for k, p in pipe._compiled.items()}
    runs = _staged_and_uncaptured(pipe, make(2))
    assert {k: p.graphs for k, p in pipe._compiled.items()} == graphs
    assert all(torch.equal(a, b) for a, b in zip(runs["staged"][0], runs["uncaptured"][0]))
    assert all(torch.equal(a, b) for a, b in zip(first, kept)) and not torch.equal(first[0], runs["staged"][0][0])


@pytest.mark.cuda
def test_encode_replay_is_bitwise_the_uncaptured_inversion():
    """encode replays ("vae_encode_mode", ...) and ("encode", steps, ...):
    bitwise the uncaptured inversion, for other images too, each result a
    tensor of its own that outlives the next replay."""
    _cuda()
    pipe = _tiny_latent_pipeline()
    images = [pipe(batch_size=2, steps=3, generator=_gen(s)).images for s in (4, 5)]
    first = pipe.encode(images[0], steps=6)
    kept = first.clone()
    assert [k[0] for k in pipe._compiled if k[0] != "fused"] == ["vae_encode_mode", "encode"]
    before = gn.group_norm_silu.launches
    second = pipe.encode(images[1], steps=6)
    torch.cuda.synchronize()
    replay_launches = gn.group_norm_silu.launches - before
    with pipe._uncaptured():
        before = gn.group_norm_silu.launches
        eager = [pipe.encode(im, steps=6) for im in images]
        torch.cuda.synchronize()
        eager_launches = (gn.group_norm_silu.launches - before) // 2
    assert torch.equal(first, kept) and torch.equal(first, eager[0]) and torch.equal(second, eager[1])
    assert replay_launches == eager_launches > 0


@pytest.mark.cuda
def test_a_stage_captured_outside_the_window_is_not_replayed_inside_it():
    """cuDNN's flag is in every stage's key: inside the batcher's window
    (cuDNN off) a staged call captures its own stages and gives the
    uncaptured result with cuDNN off, not a replay of the cuDNN kernels."""
    _cuda()
    from audio_diffusion_torch.utils import batch_invariant

    pipe = _tiny_latent_pipeline()

    def make():
        return dict(batch_size=2, steps=3, generator=_gen(6))

    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = True
    try:
        _staged_and_uncaptured(pipe, make)
        outside, fixed_outside = dict(pipe._compiled), pipe._fixed_key()
        with batch_invariant.window():
            runs = _staged_and_uncaptured(pipe, make)
            inside, fixed_inside = {k: p for k, p in pipe._compiled.items() if k not in outside}, pipe._fixed_key()
    finally:
        torch.backends.cudnn.enabled = enabled
    assert fixed_outside[3] is True and fixed_inside[3] is False  # cudnn.enabled
    assert len(inside) == len(outside) == 3 and all(p.graphs for p in inside.values())
    assert all(k[-len(fixed_inside):] == fixed_inside for k in inside)
    assert all(torch.equal(a, b) for a, b in zip(runs["staged"][0], runs["uncaptured"][0]))


# ------------------------------------------------------------ measurement programs

@pytest.mark.cuda
def test_bench_quick_on_the_card_launches_both_kernels_and_passes_its_gates():
    """``python -m audio_diffusion_torch.bench --quick``'s path in-process:
    the device block names the card, the timed windows launch each kernel
    as often as the quick UNet's blocks call it, and the gates pass."""
    _cuda()
    from audio_diffusion_torch import bench
    from audio_diffusion_torch.models import UNet2D, UNetConfig
    from audio_diffusion_torch.models.unet2d import ResnetBlock2D, SelfAttention2D

    steps = 2
    out = bench.main(["--quick", "--steps", str(steps), "--iters", "2", "--reps", "2"])
    assert out["device"]["platform"] == "gpu" and out["device"]["name"] == torch.cuda.get_device_name(0)
    assert out["device"]["count"] == torch.cuda.device_count() and out["value"] > 0
    modules = list(UNet2D(UNetConfig(**bench.QUICK_UNET)).modules())
    per_forward = {"group_norm_silu": 2 * sum(isinstance(m, ResnetBlock2D) for m in modules),
                   "flash_mha": sum(isinstance(m, SelfAttention2D) for m in modules),
                   "batch_invariant_conv2d": 0}  # outside the batcher's window
    assert out["launches"]["requests"] == 4
    assert out["launches"]["per_request"] == {k: float(v * steps) for k, v in per_forward.items()}
    assert out["setup"]["capture_s"] > 0 and out["setup"]["pool_bytes"] >= 0
    fid = out["fidelity"]
    assert fid["fused_staged_audio_lsb"] <= bench.AUDIO_LSB_BOUND and fid["gl_roundtrip_mae"] < fid["gl_bound"]


@pytest.mark.cuda
def test_mfu_counts_the_same_on_the_card_as_on_the_cpu():
    _cuda()
    from audio_diffusion_torch.scripts import mfu

    card = mfu.main(["--no_time", "--batch", "2", "--steps", "2"])
    cpu = mfu.main(["--no_time", "--device", "cpu", "--batch", "2", "--steps", "2"])
    assert card["device"]["platform"] == "gpu" and cpu["device"]["platform"] == "cpu"
    assert all(card[k] == cpu[k] for k in ("denoise_scan", "vae_decode", "request"))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [["--precast"], ["--conditional"]], ids=["precast", "conditional"])
def test_mfu_times_the_stage_programs(extra):
    """mfu at full width on a short loop: every share in (0, 1.05]; the
    precast denoise loop gives the same latents."""
    _cuda()
    from audio_diffusion_torch.scripts import mfu

    out = mfu.main(["--batch", "2", "--steps", "2", "--reps", "2", *extra])
    assert all(0 < out[k]["mfu"] <= mfu.MFU_IMPOSSIBLE for k in ("denoise_scan", "vae_decode", "request"))
    assert out["mfu"] == out["request"]["mfu"] and out["peak_precision"] == "bfloat16"
    if "--precast" in extra:
        assert out["precast_same_latents"] is True


@pytest.mark.cuda
def test_bench_serving_refuses_more_mesh_devices_than_cards():
    _cuda()
    from audio_diffusion_torch.scripts import bench_serving

    with pytest.raises(ValueError, match="mesh_data"):
        bench_serving.main(["--model", "unused", "--mesh_data", str(torch.cuda.device_count() + 1)])


@pytest.mark.cuda
def test_adversarial_vae_steps_repeat_themselves_bitwise():
    """From one state past disc_start (a 32/64-channel VAE on 256x256 slices,
    the recipe's, with the full-width PatchGAN: 64 channels, 3 layers), one
    generator step and one discriminator step, each run twice on a copy of
    that state with one batch and one posterior draw: every gradient, metric
    and parameter bitwise equal (cuDNN's deterministic algorithms inside the
    steps; without them the PatchGAN's first convolution's data gradient at
    this shape differs between runs, scripts/repeat_probe.py)."""
    _cuda()
    from audio_diffusion_torch.scripts import repeat_probe as rp

    state, gen_step, disc_step = rp.vae_setup("cuda", resolution=256, base_channels=32, ch_mult=(1, 2), groups=8,
                                              disc_start=2)
    assert state.disc.conv_in.out_channels == 64 and state.disc.n_layers == 3
    g = torch.Generator(device="cuda").manual_seed(0)

    def batches():
        while True:
            yield torch.rand((1, 2, 256, 256, 1), generator=g, device="cuda") * 2 - 1

    source = batches()
    state = rp.vae_steps(state, gen_step, disc_step, source, 3, disc_start=2)
    assert state.step == 3
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled)
    pair = rp.vae_pair(state, gen_step, disc_step, next(source))
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled) == flags
    for step in ("gen_step", "disc_step"):
        assert pair[step]["bitwise"], pair[step]
    assert pair["gen_step"]["metrics"]["g_loss"][0] != 0  # the adversarial term is on


@pytest.mark.cuda
def test_bf16_unet_step_repeats_itself_bitwise():
    """One bf16 step of the full-width latent-256 UNet over cached latents
    (microbatch 16), run twice from one initial state: the gradient, the loss
    and every parameter after the update bitwise equal."""
    _cuda()
    from audio_diffusion_torch.scripts import repeat_probe as rp

    pair = rp.unet_pair("cuda")
    assert pair["bitwise"], pair


@pytest.mark.cuda
def test_conditional_unet_step_and_its_attention_repeat_themselves_bitwise():
    """One bf16 step of the full-width conditional-latent-512 UNet (64x64
    latents, an encoding per row, 8 x 2 microbatches as the 512 recipe
    trains it), run twice from one initial state: every gradient and
    parameter bitwise equal. Its attention core at the first level's
    self-attention shape through ``SDPA`` twice: bitwise, where torch's own
    backward is not (scripts/repeat_probe.py)."""
    _cuda()
    from audio_diffusion_torch.scripts import repeat_probe as rp

    pair = rp.unet_pair("cuda", (64, 64), micro=8, accum=2, cross_attention_dim=100)
    assert pair["bitwise"], {k: v for k, v in pair.items() if k != "attention"}
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, grad = (torch.randn((8, 4096, 8, 16), generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    runs = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        runs.append(torch.autograd.grad(at.SDPA.apply(*leaves), leaves, grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.are_deterministic_algorithms_enabled()


# ------------------------------------------------------------- batch-invariant convolution

def _bf16_conv_layers(config):
    """The distinct bf16 convolutions of a served batch of ``config``: (row shape, weight shape, stride, padding)."""
    from test_torch_conv2d import conv_layers

    return sorted({(x[1:], w, s, p) for x, w, s, p, dtype, _ in conv_layers(config, 2) if dtype == torch.bfloat16})


def _conv_operands(rows, shape, w_shape, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, *shape), generator=g, device="cuda").bfloat16()
    w = torch.randn(w_shape, generator=g, device="cuda") * (w_shape[1] * w_shape[2] * w_shape[3]) ** -0.5
    return x, w, torch.randn(w_shape[0], generator=g, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["latent-256", "cond-latent-512"])
def test_batch_invariant_conv2d_matches_an_f32_conv_over_the_rounded_operands(config):
    """Every bf16 convolution shape of the configuration's UNet, VAE decoder
    and encoder at batch 2 against F.conv2d in f32 (TF32 off) over the same
    bf16-rounded input, weight and bias, within one bf16 ulp (the output is
    rounded once; the kernel's f32 sums run in another order); one launch a
    call."""
    _cuda()
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for shape, w_shape, stride, padding in _bf16_conv_layers(config):
                x, w, b = _conv_operands(2, shape, w_shape)
                before = bic.batch_invariant_conv2d.launches
                y = bic.batch_invariant_conv2d(x, w, b, stride, padding)
                assert bic.batch_invariant_conv2d.launches == before + 1
                ref = F.conv2d(x.float(), w.bfloat16().float(), b.bfloat16().float(), stride, padding)
                assert y.dtype == torch.bfloat16 and y.shape == ref.shape and y.is_contiguous()
                _assert_within_a_bf16_ulp(y, ref)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["latent-256", "cond-latent-512"])
def test_batch_invariant_conv2d_rows_do_not_depend_on_the_batch(config):
    """Every bf16 convolution shape of the configuration (stride 2, the 1x1
    kernels and the 4x4, 2x2 and 1x1 levels among them): each batch of 1, 2,
    4, 8, 16 and 32 rows gives its rows the bits they have in the batch of 32
    (8 for the largest VAE levels), and the last row alone gives its bits
    there too."""
    _cuda()
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic

    with torch.inference_mode():
        for shape, w_shape, stride, padding in _bf16_conv_layers(config):
            n = 32 if np.prod(shape) <= 1 << 23 else 8
            x, w, b = _conv_operands(n, shape, w_shape)
            full = bic.batch_invariant_conv2d(x, w, b, stride, padding)
            for rows in (1, 2, 4, 8, 16, 32):
                if rows <= n:
                    assert torch.equal(bic.batch_invariant_conv2d(x[:rows], w, b, stride, padding), full[:rows]), \
                        (shape, w_shape, stride, rows)
            assert torch.equal(bic.batch_invariant_conv2d(x[n - 1:], w, b, stride, padding), full[n - 1:])


def _full_width_bf16_pipeline():
    """The latent-256 pipeline at full width in bf16 with the GroupNorm
    kernel, seeded random weights (the served model of the benchmark)."""
    from audio_diffusion_torch.mel import Mel
    from audio_diffusion_torch.models import AutoencoderKL, UNet2D, VAEConfig, unconditional_config
    from audio_diffusion_torch.pipelines import AudioDiffusionPipeline
    from audio_diffusion_torch.schedulers import DDIMScheduler

    vae = AutoencoderKL(VAEConfig(sample_size=256, dtype="bfloat16")).init_params(torch.Generator().manual_seed(1))
    unet = UNet2D(unconditional_config(sample_size=(32, 32), dtype="bfloat16", fused_groupnorm=True)).init_params(
        torch.Generator().manual_seed(0))
    return AudioDiffusionPipeline(unet, Mel(x_res=256, y_res=256, hop_length=512, device="cuda"), DDIMScheduler(),
                                  vae, device="cuda")


@pytest.mark.cuda
def test_bf16_served_request_is_bitwise_the_same_at_tiers_1_8_and_32_through_the_conv_kernel():
    """The serving contract in bf16 through DynamicBatcher, 50 DDIM steps at
    eta 0: seed 7 alone (tier 1), among 7 others (tier 8) and among 31 others
    (tier 32) gives one uint8 spectrogram. Every batch launches the
    convolution kernel once per bf16 convolution of each UNet forward and of
    the VAE decode (graph replays credit the counter); a call outside the
    window launches it never."""
    _cuda()
    from audio_diffusion_torch.models.unet2d import Conv2d
    from audio_diffusion_torch.ops import batch_invariant_conv2d as bic
    from audio_diffusion_torch.serving import DynamicBatcher

    pipe = _full_width_bf16_pipeline()
    per_batch = 50 * sum(isinstance(m, Conv2d) for m in pipe.unet.modules()) + sum(
        isinstance(m, Conv2d) for m in pipe.vqvae.decoder.modules())
    before = bic.batch_invariant_conv2d.launches
    pipe(batch_size=2, steps=2, generator=torch.Generator(device="cuda").manual_seed(0))
    assert bic.batch_invariant_conv2d.launches == before
    batcher = DynamicBatcher(pipe, max_batch=32, max_wait_ms=3000, steps=50)
    try:
        batcher.warmup()
        before = bic.batch_invariant_conv2d.launches
        solo = batcher.submit(seed=7).result(timeout=600)
        futs = [batcher.submit(seed=s) for s in (7, *range(100, 107))]
        eight = [f.result(timeout=600) for f in futs]
        futs = [batcher.submit(seed=s) for s in (7, *range(200, 231))]
        thirty_two = [f.result(timeout=600) for f in futs]
        launches = bic.batch_invariant_conv2d.launches - before
    finally:
        batcher.close()
    assert [(s["n"], s["tier"]) for s in batcher.stats][-3:] == [(1, 1), (8, 8), (32, 32)]
    assert launches == 3 * per_batch
    assert solo.image.shape == (256, 256) and solo.image.std() > 0
    np.testing.assert_array_equal(solo.image, eight[0].image)
    np.testing.assert_array_equal(solo.image, thirty_two[0].image)
    assert not np.array_equal(eight[0].image, eight[1].image)
