"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch import build_model, segmentation_distribution, use_fp32_numerics
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu, conv_bn_stats, reparam, resize_mm
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


def cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", [(8, 64, 32, 32), (2, 6, 5, 7), (3, 512, 4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = shape[1]
    x = cl(torch.randn(shape, device=cuda, generator=g).to(dtype))
    stats = [torch.rand(c, device=cuda, generator=g) + 0.5 for _ in range(4)]
    before = _ext.launch_counts()["bn_relu"]
    y = bn_relu.fused_bn_relu(x, *stats)
    assert _ext.launch_counts()["bn_relu"] == before + 1
    ref = bn_relu.fused_bn_relu_plain(x, *bn_relu.fold(*stats))
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    # products and sums rounded as torch rounds them: the same bits
    assert torch.equal(y, ref)


@pytest.mark.parametrize("shape,out_hw", [((8, 64, 16, 16), (32, 32)), ((2, 1, 32, 32), (64, 64)),
                                          ((1, 5, 7, 9), (19, 4))])
@pytest.mark.parametrize("ac", [True, False])
def test_resize_kernel_matches_plain(cuda, shape, out_hw, ac):
    x = cl(torch.randn(shape, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)))
    y = resize_mm.resize(x, out_hw, ac)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, resize_mm.resize_plain(x, out_hw, ac), atol=1e-6, rtol=0)
    lib = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=ac)
    torch.testing.assert_close(y, lib, atol=1e-5, rtol=0)


def test_noise_kernels_match_plain(cuda):
    z = reparam.normal((8192, 64), 11, cuda)
    torch.testing.assert_close(z, reparam.normal_plain((8192, 64), 11, cuda), atol=1e-5, rtol=0)
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1) < 0.01
    mu = torch.randn(10, 32, device=cuda)
    logvar = torch.randn(10, 32, device=cuda)
    torch.testing.assert_close(reparam.reparameterize(mu, logvar, 5, 1.5),
                               reparam.reparameterize_plain(mu, logvar, 5, 1.5),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("shape", [(8192, 64), (3, 32), (1, 32), (7, 5), (1, 33),
                                   (16, 512, 512, 3)])
def test_noise_kernel_matches_plain_at_every_count(cuda, shape):
    """One Philox call per 4 elements, the last one masked where the count
    is not a multiple of 4: the plain stream within 1e-5 (the ulps of log,
    sin and cos); a repeat gives the same bits, a new seed others, and a
    draw is the prefix of a longer one."""
    z = reparam.normal(shape, 11, cuda)
    torch.testing.assert_close(z, reparam.normal_plain(shape, 11, cuda), atol=1e-5, rtol=0)
    assert torch.equal(z, reparam.normal(shape, 11, cuda))
    assert not torch.equal(z, reparam.normal(shape, 12, cuda))
    n = z.numel()
    assert torch.equal(z.flatten(), reparam.normal((n + 5,), 11, cuda)[:n])


@pytest.mark.parametrize("shape", [(10, 32), (3, 5)])
def test_reparameterize_is_mu_plus_the_noise_times_std_on_the_card(cuda, shape):
    """The fused kernel draws the noise kernel's stream: z = mu + normal x
    exp(logvar / 2) x T, within 1e-5 (the ulps of exp)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    mu = torch.randn(shape, device=cuda, generator=g)
    logvar = torch.randn(shape, device=cuda, generator=g)
    z = reparam.reparameterize(mu, logvar, 5, 1.5)
    eps = reparam.normal(shape, 5, cuda)
    torch.testing.assert_close(z, mu + eps * (torch.exp(0.5 * logvar) * 1.5), atol=1e-5, rtol=0)


def test_slice_on_the_card_matches_the_cpu(cuda):
    model = build_model(backbone="resnet18", seed=0, device=cuda)
    img = torch.rand((96, 80, 3), generator=torch.Generator().manual_seed(2))
    eps = torch.randn((2, 1, 32), generator=torch.Generator().manual_seed(3))
    gpu = segmentation_distribution(model, img, num_samples=2, patch_size=64, eps=eps,
                                    device=cuda)
    cpu = segmentation_distribution(model.to("cpu"), img, num_samples=2, patch_size=64,
                                    eps=eps, device="cpu")
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], atol=2e-4, rtol=0)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], atol=1e-4, rtol=0)


def _conv_case(cuda, shape, co, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = cl(torch.randn(shape, device=cuda, generator=g).to(dtype))
    w = (torch.randn((co, shape[1], 3, 3), device=cuda, generator=g) * 0.2).to(dtype)
    return x, w


def _moment_loss(y, s, q):
    return torch.tanh(y.float()).sum() + 0.3 * s.sum() + 0.1 * q.sum()


def _check_conv(cuda, shape, co, dtype):
    """y and the moments against the fp32 plain version, a repeat call bit
    for bit, the launch count, and the Function's backward against the plain
    version's autograd.  fp32: errors within 1e-5 of the magnitudes summed
    (conv of |x| with |w|, sum of |y|), the room fp32 rounding in another
    order needs; bf16: y within one bf16 ulp on top of that, since the two
    fp32 values can round to neighbours (the tensor cores sum in another
    order than the fp32 reference)."""
    x, w = _conv_case(cuda, shape, co, dtype)
    counter = ("conv_bn_stats_ci8" if conv_bn_stats.route(shape[1], co, dtype)
               == conv_bn_stats.SMALL_CI_ENTRY else "conv_bn_stats")
    before = _ext.launch_counts()[counter]
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x, w)
    assert _ext.launch_counts()[counter] == before + 1
    ry, rs, rq = conv_bn_stats.conv3x3_bn_stats_plain(x, w)
    mag = F.conv2d(x.float().abs(), w.float().abs(), padding=1)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    ulp = torch.maximum(y.float().abs(), ry.float().abs()) * 2.0 ** -7 if dtype != torch.float32 \
        else torch.zeros_like(mag)
    assert ((y.float() - ry.float()).abs() <= 1e-5 * mag + ulp + 1e-30).all()
    rel = 1e-5 if dtype == torch.float32 else 1e-4
    assert ((s - rs).abs() <= rel * ry.float().abs().sum(dim=(0, 2, 3)) + 1e-30).all()
    assert ((q - rq).abs() <= rel * rq).all()
    y2, s2, q2 = conv_bn_stats.conv3x3_bn_stats(x, w)
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(q, q2)
    xk, wk = x.detach().requires_grad_(), w.detach().requires_grad_()
    _moment_loss(*conv_bn_stats.conv3x3_bn_stats(xk, wk)).backward()
    xp, wp = x.detach().requires_grad_(), w.detach().requires_grad_()
    _moment_loss(*conv_bn_stats.conv3x3_bn_stats_plain(xp, wp)).backward()
    for a, b in ((xk.grad, xp.grad), (wk.grad, wp.grad)):
        scale = b.float().abs().max()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(a.float(), b.float(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("shape,co", [((2, 5, 12, 13), 7), ((2, 20, 17, 35), 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_stats_kernel_matches_plain(cuda, shape, co, dtype):
    _check_conv(cuda, shape, co, dtype)


@pytest.mark.parametrize("shape,co", [
    ((2, 64, 12, 20), 64),      # Ci one chunk, BN 64; H, W off the 8 x 16 tile
    ((2, 224, 9, 23), 128),     # a ragged last chunk (224 = 3.5 x 64), BN 128
    ((1, 800, 17, 18), 512),    # 12.5 chunks, four channel blocks
    ((2, 64, 16, 16), 512),
    ((2, 13, 10, 19), 70),      # Ci % 8 != 0: x and w zero-padded to 16; Co over one block
    ((1, 224, 31, 7), 64)])
def test_conv_bn_stats_tensor_core_kernel_matches_plain(cuda, shape, co):
    _check_conv(cuda, shape, co, torch.bfloat16)


@pytest.mark.parametrize("shape,co", [
    ((1, 1, 13, 70), 64),       # Ci = 1: one K step; W one tile and a ragged one
    ((2, 3, 9, 67), 64),        # the plain UNet's Ci = 3: K 27 -> 32; H, W off the 4 x 64 tile
    ((1, 4, 5, 129), 64),       # K 36 -> 48
    ((2, 8, 17, 3), 64),        # K 72 -> 80; W under one tile
    ((1, 3, 6, 20), 72),        # two channel blocks, the second of 8
    ((1, 5, 64, 64), 16)])      # whole tiles; Co under one block
def test_conv_bn_stats_small_ci_kernel_matches_plain(cuda, shape, co):
    assert conv_bn_stats.route(shape[1], co, torch.bfloat16) == conv_bn_stats.SMALL_CI_ENTRY
    _check_conv(cuda, shape, co, torch.bfloat16)


def test_conv_bn_stats_small_ci_kernel_refuses_a_co_off_8(cuda):
    """The C entry refuses a Co that is not a multiple of 8 instead of
    writing past the pixel's channels; the wrapper never sends one."""
    x, w = _conv_case(cuda, (1, 3, 8, 8), 8, torch.bfloat16)
    fn, args, _, keep = conv_bn_stats.launch_args(x, w)
    assert fn == conv_bn_stats.SMALL_CI_ENTRY
    bad = list(args)
    bad[11] = 7                                   # Co
    with pytest.raises(RuntimeError, match="failed with CUDA error"):
        _ext.call("conv_bn_stats", fn, cuda, *bad)


@pytest.mark.parametrize("shape,co", [
    ((2, 64, 12, 20), 64),      # whole 16-byte channel vectors; H, W off the 8 x 16 tile
    ((1, 224, 9, 23), 128),     # 28 chunks of 8; two channel blocks
    ((1, 800, 17, 18), 512),    # the deepest conv of the step: 100 chunks, eight blocks
    ((2, 5, 10, 19), 7),        # Ci off a vector: the 4-byte copies; Co off a vector
    ((2, 6, 8, 16), 70),        # a ragged last chunk and a ragged last channel block
    ((1, 64, 31, 7), 64)])
def test_conv_bn_stats_fp32_kernel_matches_plain(cuda, shape, co):
    _check_conv(cuda, shape, co, torch.float32)


def test_conv_bn_stats_fp32_kernel_off_a_16_byte_address(cuda):
    """x four bytes off a 16-byte address takes the 4-byte copies and gives
    the aligned call's bits."""
    x, w = _conv_case(cuda, (2, 8, 9, 17), 12, torch.float32)
    base = torch.zeros(x.numel() + 1, device=cuda)
    base[1:] = x.permute(0, 2, 3, 1).reshape(-1)
    off = base[1:].view(2, 9, 17, 8).permute(0, 3, 1, 2)
    assert off.data_ptr() % 16 == 4 and off.is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(conv_bn_stats.conv3x3_bn_stats(off, w), conv_bn_stats.conv3x3_bn_stats(x, w)):
        assert torch.equal(a, b)


def test_conv_bn_stats_fp32_kernel_launches_on_a_side_stream(cuda):
    x, w = _conv_case(cuda, (1, 8, 8, 16), 64, torch.float32)
    x.zero_()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.fill_(1.0)
        y, s, q = conv_bn_stats.conv3x3_bn_stats(x, w)
    side.synchronize()
    ry, rs, rq = conv_bn_stats.conv3x3_bn_stats_plain(x, w)
    torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, rs, atol=1e-3, rtol=1e-5)


def test_conv_bn_stats_tensor_core_layout_with_an_identity_weight(cuda):
    """Only the centre tap, channel c to channel c: y must be x exactly,
    which shows the TMA boxes, the swizzle and the accumulator layout
    before any arithmetic."""
    x = cl(torch.randn((2, 64, 12, 20), device=cuda).to(torch.bfloat16))
    w = torch.zeros((64, 64, 3, 3), device=cuda)
    w[torch.arange(64), torch.arange(64), 1, 1] = 1.0
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x, w.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    torch.testing.assert_close(s, x.float().sum(dim=(0, 2, 3)), atol=1e-3, rtol=1e-5)


def test_launch_path_uses_the_current_stream_and_raises_on_an_error(cuda):
    """Under torch.cuda.stream(side) a kernel launches on the side stream:
    it runs after the side stream's fill, which a busy wait holds back, so
    on the default stream it would read the zeros.  A non-zero return code
    still raises, and the counts still move."""
    x = cl(torch.zeros((1, 8, 4, 4), device=cuda))
    one, zero = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = _ext.launch_counts()["bn_relu"]
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.fill_(2.0)
        y = bn_relu.fused_bn_relu(x, one, zero, zero, one - 1e-5)
    side.synchronize()
    assert _ext.launch_counts()["bn_relu"] == before + 1
    torch.testing.assert_close(y, torch.full_like(y, 2.0))
    s = torch.empty(4, device=cuda)
    with pytest.raises(RuntimeError, match="vaeunet_conv3x3_stats_f32 failed with CUDA error"):
        # a scratch of 3 rows for 1 tile: the C entry refuses it and launches nothing
        _ext.call("conv_bn_stats", "vaeunet_conv3x3_stats_f32", cuda, x.data_ptr(),
                  s.data_ptr(), s.data_ptr(), s.data_ptr(), s.data_ptr(), s.data_ptr(),
                  s.data_ptr(), 1, 4, 4, 8, 1, 32, 64, 3)
    with pytest.raises(RuntimeError, match="vaeunet_conv3x3_stats_f32 failed with CUDA error"):
        # weights padded to fewer channels than the block reads: refused as well
        _ext.call("conv_bn_stats", "vaeunet_conv3x3_stats_f32", cuda, x.data_ptr(),
                  s.data_ptr(), s.data_ptr(), s.data_ptr(), s.data_ptr(), s.data_ptr(),
                  s.data_ptr(), 1, 4, 4, 8, 1, 8, 4, 1)


@pytest.mark.parametrize("shape,out_hw", [((2, 8, 16, 16), (32, 32)), ((1, 5, 7, 9), (19, 4)),
                                          ((2, 3, 20, 30), (9, 13)), ((2, 1, 32, 32), (64, 64))])
@pytest.mark.parametrize("ac", [True, False])
def test_resize_bwd_kernel_matches_plain_and_interpolate(cuda, shape, out_hw, ac):
    """gx = M^T g against the plain index_add_ version (atomics on the
    card, so fp32 order differs: 1e-6 of the magnitudes summed) and against
    the gradient of F.interpolate (1e-5 of them)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = cl(torch.randn((shape[0], shape[1], *out_hw), device=cuda, generator=gen))
    before = _ext.launch_counts()["resize_bwd"]
    gx = resize_mm.resize_backward(g, shape[2:], ac)
    assert _ext.launch_counts()["resize_bwd"] == before + 1
    ref = resize_mm.resize_backward_plain(g, shape[2:], ac)
    mag = resize_mm.resize_backward_plain(g.abs(), shape[2:], ac)
    x = torch.zeros(shape, device=cuda, requires_grad=True)
    lib, = torch.autograd.grad(F.interpolate(x, size=out_hw, mode="bilinear",
                                             align_corners=ac), x, g)
    torch.cuda.synchronize()
    assert gx.is_contiguous(memory_format=torch.channels_last)
    assert ((gx - ref).abs() <= 1e-6 * mag + 1e-30).all()
    assert ((gx - lib).abs() <= 1e-5 * mag + 1e-30).all()
    # an NCHW-contiguous gradient is taken as it comes
    torch.testing.assert_close(resize_mm.resize_backward(g.contiguous(), shape[2:], ac), gx,
                               atol=0, rtol=0)


# H, W, OH, OW off every tile; C on both routes (1, 3 scalar; 4 scalar in bf16; 72 a ragged
# last chunk; 512 several chunks); the last case a downsample, whose lists have empty rows
RAGGED_RESIZES = [((2, c, 13, 21), (29, 45)) for c in (1, 3, 4, 8, 72, 512)] + \
                 [((1, 8, 37, 50), (17, 23))]


def _other_route(src, dst_like, ac, backward):
    """The scalar kernel's result on the same input."""
    other = torch.empty_like(dst_like)
    fn, args = resize_mm.launch_args(src, other, ac, backward=backward, scalar=True)
    assert "_scalar_" in fn
    _ext.call("resize", fn, src.device, *args)
    return other


@pytest.mark.parametrize("shape,out_hw", RAGGED_RESIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ac", [True, False])
def test_resize_kernels_match_plain_at_ragged_tiles(cuda, shape, out_hw, dtype, ac):
    """Forward and backward on whichever route the shape takes: fp32 within
    1e-6 of the plain version (backward: of the magnitudes summed), bf16
    one ulp more; a second call and the scalar kernel give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = cl(torch.randn(shape, device=cuda, generator=gen).to(dtype))
    tiled = (shape[1] * x.element_size()) % 16 == 0
    assert resize_mm.launch_args(x, x, ac)[0].count("_scalar_") == (0 if tiled else 1)
    y = resize_mm.resize(x, out_hw, ac)
    ref = resize_mm.resize_plain(x, out_hw, ac)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    ulp = ref.float().abs() * 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert ((y.float() - ref.float()).abs() <= 1e-6 + ulp).all()
    assert torch.equal(y, resize_mm.resize(x, out_hw, ac))
    assert torch.equal(y, _other_route(x, y, ac, False))

    g = cl(torch.randn((shape[0], shape[1], *out_hw), device=cuda, generator=gen).to(dtype))
    gx = resize_mm.resize_backward(g, shape[2:], ac)
    ref = resize_mm.resize_backward_plain(g, shape[2:], ac)
    mag = resize_mm.resize_backward_plain(g.float().abs(), shape[2:], ac)
    torch.cuda.synchronize()
    assert gx.dtype == dtype and gx.is_contiguous(memory_format=torch.channels_last)
    ulp = gx.float().abs() * 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert ((gx.float() - ref.float()).abs() <= 1e-6 * mag + ulp + 1e-30).all()
    assert torch.equal(gx, resize_mm.resize_backward(g, shape[2:], ac))
    assert torch.equal(gx, _other_route(g, gx, ac, True))


@pytest.mark.parametrize("tile,lanes", [((1, 1), 1), ((2, 32), 2), ((32, 2), 4), ((4, 4), 32)])
def test_tiled_resize_kernels_at_other_tiles_and_lanes(cuda, tile, lanes):
    """Tiles and lanes the rule does not choose give the rule's bits."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = cl(torch.randn((2, 72, 13, 21), device=cuda, generator=gen))
    y = resize_mm.resize(x, (29, 45), False)
    gx = resize_mm.resize_backward(y, (13, 21), False)
    for src, dst, backward in ((x, y, False), (y, gx, True)):
        planner = resize_mm.plan_backward if backward else resize_mm.plan_forward
        plan = planner((13, 21), (29, 45), 72, 4, False, 2, tile, lanes)
        other = torch.full_like(dst, float("nan"))
        fn, args = resize_mm.launch_args(src, other, False, backward=backward, plan=plan)
        _ext.call("resize", fn, src.device, *args)
        assert torch.equal(other, dst)


def test_tiled_resize_kernels_launch_on_a_side_stream(cuda):
    """As for bn_relu above: the side stream's fill is held back by a busy
    wait, so a launch on the default stream would read the zeros."""
    x = cl(torch.zeros((1, 8, 6, 6), device=cuda))
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.fill_(2.0)
        y = resize_mm.resize(x, (12, 12), True)
        gx = resize_mm.resize_backward(y, (6, 6), True)
    side.synchronize()
    torch.testing.assert_close(y, torch.full_like(y, 2.0))
    torch.testing.assert_close(gx, resize_mm.resize_backward_plain(torch.full_like(y, 2.0),
                                                                   (6, 6), True))


def test_a_refused_tiled_launch_raises(cuda):
    """Shared memory over the card's limit: raising the kernel's limit
    fails, the C entry returns that error and nothing is launched."""
    x = cl(torch.zeros((1, 8, 6, 6), device=cuda))
    y = cl(torch.zeros((1, 8, 12, 12), device=cuda))
    fn, args = resize_mm.launch_args(x, y, True)
    with pytest.raises(RuntimeError, match="vaeunet_resize_f32 failed with CUDA error"):
        _ext.call("resize", fn, cuda, *args[:-1], 400_000)


# the logits resize and its like: C = 1 with an output row of whole 16-byte vectors
ROW_RESIZES = [((8, 1, 256, 256), (512, 512)), ((2, 1, 13, 21), (29, 48)),
               ((1, 1, 37, 56), (17, 24)), ((3, 1, 16, 10), (16, 40)), ((2, 1, 9, 8), (20, 8))]


@pytest.mark.parametrize("shape,out_hw", ROW_RESIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ac", [True, False])
def test_row_resize_kernel_gives_the_scalar_and_plain_bits(cuda, shape, out_hw, dtype, ac):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = cl(torch.randn(shape, device=cuda, generator=gen).to(dtype))
    y = torch.full((shape[0], 1, *out_hw), float("nan"), device=cuda, dtype=dtype)
    y = cl(y)
    fn, args = resize_mm.launch_args(x, y, ac)
    assert "_row_" in fn
    before = _ext.launch_counts()["resize"]
    out = resize_mm.resize(x, out_hw, ac)
    assert _ext.launch_counts()["resize"] == before + 1 and out.grad_fn is None
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, resize_mm.resize_plain(x, out_hw, ac))
    assert torch.equal(out, _other_route(x, out, ac, False))
    assert torch.equal(out, resize_mm.resize(x, out_hw, ac))
    if dtype == torch.float32:
        lib = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=ac)
        torch.testing.assert_close(out, lib, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tile", [(1, 8), (2, 64), (64, 8), (8, 512)])
def test_row_resize_kernel_at_other_tiles(cuda, tile):
    gen = torch.Generator(device=cuda).manual_seed(10)
    for dtype in (torch.float32, torch.bfloat16):
        x = cl(torch.randn((2, 1, 45, 52), device=cuda, generator=gen).to(dtype))
        want = resize_mm.resize(x, (77, 104), False)
        plan = resize_mm.plan_forward((45, 52), (77, 104), 1, x.element_size(), False, 2, tile)
        other = torch.full_like(want, float("nan"))
        fn, args = resize_mm.launch_args(x, other, False, plan=plan)
        assert "_row_" in fn
        _ext.call("resize", fn, x.device, *args)
        assert torch.equal(other, want)


def test_one_channel_resize_off_a_vector_takes_the_scalar_route(cuda):
    x = cl(torch.randn((2, 1, 13, 21), device=cuda))
    y = cl(torch.empty((2, 1, 29, 45), device=cuda))
    assert "_scalar_" in resize_mm.launch_args(x, y, True)[0]
    torch.testing.assert_close(resize_mm.resize(x, (29, 45), True),
                               resize_mm.resize_plain(x, (29, 45), True), atol=1e-6, rtol=0)


def test_a_refused_row_launch_raises(cuda):
    x = cl(torch.zeros((1, 1, 8, 8), device=cuda))
    y = cl(torch.zeros((1, 1, 16, 16), device=cuda))
    fn, args = resize_mm.launch_args(x, y, True)
    with pytest.raises(RuntimeError, match="vaeunet_resize_row_f32 failed with CUDA error"):
        _ext.call("resize", fn, cuda, *args[:-1], 400_000)
    # the refusal left nothing behind: the next launch goes through
    assert torch.equal(resize_mm.resize(x, (16, 16), True), y)


def test_resize_call_forms_with_and_without_a_graph(cuda):
    """No graph to record: a direct launch, no grad_fn.  A leaf that
    requires grad: the Function, whose backward is the gradient kernel."""
    x = cl(torch.randn((2, 1, 16, 16), device=cuda))
    with torch.no_grad():
        a = resize_mm.resize(x.clone().requires_grad_(), (32, 32), True)
    with torch.inference_mode():
        b = resize_mm.resize(x, (32, 32), True)
    c = resize_mm.resize(x, (32, 32), True)
    leaf = x.clone().requires_grad_()
    d = resize_mm.resize(leaf, (32, 32), True)
    assert a.grad_fn is None and c.grad_fn is None and d.grad_fn is not None
    assert torch.equal(a, c) and torch.equal(b.clone(), c) and torch.equal(d.detach(), c)
    before = _ext.launch_counts()["resize_bwd"]
    d.sum().backward()
    assert _ext.launch_counts()["resize_bwd"] == before + 1
    torch.testing.assert_close(
        leaf.grad, resize_mm.resize_backward_plain(torch.ones_like(d), (16, 16), True),
        atol=1e-6, rtol=0)


def test_resize_gradient_reaches_the_input_on_cuda(cuda):
    """The resize kernel's output carries a grad_fn: a training forward is
    not cut at the decoder's resizes, and the gradient equals the CPU's."""
    x_cpu = torch.randn((2, 6, 9, 11), generator=torch.Generator().manual_seed(4))
    x_cpu = cl(x_cpu).requires_grad_()
    x_gpu = x_cpu.detach().to(cuda).requires_grad_()
    w = torch.randn((2, 6, 20, 17), generator=torch.Generator().manual_seed(5))
    before = _ext.launch_counts()["resize_bwd"]
    (resize_bilinear(x_gpu, (20, 17)) * w.to(cuda)).sum().backward()
    (resize_bilinear(x_cpu, (20, 17)) * w).sum().backward()
    assert x_gpu.grad is not None
    assert _ext.launch_counts()["resize_bwd"] == before + 1
    torch.testing.assert_close(x_gpu.grad.cpu(), x_cpu.grad, atol=1e-6, rtol=0)


def test_bn_relu_kernel_refuses_autograd(cuda):
    x = cl(torch.randn((1, 4, 3, 3), device=cuda))
    scale = torch.ones(4, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        bn_relu.fused_bn_relu(x, scale, *(torch.ones(4, device=cuda),) * 3)


def test_reparameterize_kernel_refuses_autograd(cuda):
    mu = torch.zeros((2, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        reparam.reparameterize(mu, torch.zeros((2, 3), device=cuda), 1)


def test_normal_kernel_output_is_a_constant_of_the_graph(cuda):
    assert not reparam.normal((2, 3), 1, cuda).requires_grad


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """resnet18 at 64^2, batch 2, fp32 with TF32 off, the same weights,
    batch and noise on both devices: loss atol 1e-5, running statistics
    atol 1e-4 + rtol 1e-3, parameters atol 2 lr + 1e-6 (the first Adam
    step is lr g / (|g| + eps), whose sign can flip where |g| is near 0).  On the
    card the step runs through the conv, resize, resize-backward kernels."""
    lr = 1e-3
    config = TrainConfig(backbone="resnet18", batch_size=2, gradient_accumulation_steps=1,
                         amp=False, patch_size=64, learning_rate=lr)
    g = torch.Generator().manual_seed(6)
    images = torch.rand((2, 64, 64, 3), generator=g)
    masks = (torch.rand((2, 64, 64, 1), generator=g) > 0.9).float()
    eps = torch.randn((1, 2, 32), generator=g)
    out = []
    for device in (cuda, "cpu"):
        state = create_train_state(config, seed=0, device=device)
        _ext.reset_launch_counts()
        state, aux = make_train_step(config, state.model)(state, images, masks, 0.001, eps=eps)
        if device == cuda:
            counts = _ext.launch_counts()
            assert counts["conv_bn_stats"] == 13 + 8      # resnet18 encoder 13, decoder 8
            assert counts["resize"] == counts["resize_bwd"] == 5
        assert all(p.grad is not None for p in state.model.parameters())
        out.append((aux["loss"].item(), {k: v.detach().cpu()
                                         for k, v in state.model.state_dict().items()}))
    (loss_gpu, sd_gpu), (loss_cpu, sd_cpu) = out
    assert abs(loss_gpu - loss_cpu) <= 1e-5
    for k, v in sd_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running_" in k:
            torch.testing.assert_close(sd_gpu[k], v, atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(sd_gpu[k], v, atol=2 * lr + 1e-6, rtol=0, msg=k)
