"""The eval BN + ReLU kernel (the fold inside it) and the one-channel resize
gradient's row kernel on the card, against their plain versions bit for bit.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_cuda_kernels2.py -m cuda --noconftest -q
"""

import pytest
import torch

from vaeunet_tpu_torch import use_fp32_numerics
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu, resize_mm
from vaeunet_tpu_torch.ops.resize import resize_bilinear

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


def cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def stats(c: int, device, seed: int = 0) -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(c, device=device, generator=g) + 0.5,
            torch.randn(c, device=device, generator=g),
            torch.randn(c, device=device, generator=g) * 0.5,
            torch.rand(c, device=device, generator=g) + 0.5)


def offset_view(shape, dtype, device, elems: int = 1) -> torch.Tensor:
    """A channels_last NCHW view `elems` elements past a 16-byte address."""
    n, c, h, w = shape
    base = torch.randn(n * h * w * c + elems, device=device).to(dtype)
    x = base[elems:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 != 0
    return x


# the VAE-UNet request's and eval step's shapes (narrow batches), the resnet50
# encoder's C = 2048, the plain UNet's odd bottom, and ragged C
BN_RELU_SHAPES = [(8, 64, 64, 64), (8, 32, 32, 32), (8, 512, 16, 16), (2, 2048, 16, 16),
                  (1, 1024, 89, 134), (2, 6, 5, 7), (3, 12, 4, 9), (2, 4, 3, 3)]


@pytest.mark.parametrize("shape", BN_RELU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [False, True])
def test_bn_relu_folds_in_the_kernel_bit_for_bit(cuda, shape, dtype, offset):
    """The kernel's own fold (rsqrtf, each product and sum rounded) gives the
    bits of the plain version on torch's fold, on both routes: aligned
    (vector where C allows) and off a 16-byte address (scalar)."""
    x = (offset_view(shape, dtype, cuda) if offset
         else cl(torch.randn(shape, device=cuda).to(dtype)))
    st = stats(shape[1], cuda)
    before = _ext.launch_counts()["bn_relu"]
    y = bn_relu.fused_bn_relu(x, *st)
    assert _ext.launch_counts()["bn_relu"] == before + 1
    ref = bn_relu.fused_bn_relu_plain(x, *bn_relu.fold(*st))
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, ref)
    vec = 16 // x.element_size()
    route = bn_relu.plan(x.numel() // shape[1], shape[1], x.element_size(),
                         (x.data_ptr() | y.data_ptr()) % 16 == 0).route
    assert route == ("vector" if not offset and shape[1] % vec == 0 else "scalar")


def test_bn_relu_is_one_device_kernel_a_call(cuda):
    """The fold runs inside the kernel: a call launches exactly one device
    kernel and no torch op."""
    x = cl(torch.randn((8, 64, 32, 32), device=cuda))
    st = stats(64, cuda)
    bn_relu.fused_bn_relu(x, *st)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(5):
            bn_relu.fused_bn_relu(x, *st)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 5 and all("bn_relu_kernel" in n for n in device), device
    ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
    assert ops <= {"aten::empty_like", "aten::empty_strided", "aten::empty"}, ops


def test_bn_relu_refused_plan_raises(cuda):
    """A vector plan on a view off a 16-byte address is refused by the C
    entry, and nothing is launched."""
    x = offset_view((2, 8, 4, 4), torch.float32, cuda)
    y = cl(torch.empty((2, 8, 4, 4), device=cuda))
    st = stats(8, cuda)
    fn, args = bn_relu.launch_args(x, y, *st, 1e-5)
    vector = list(args)
    vector[9:] = [4, 2, 128, 1, 1]          # V = 4, a 2 x 128 block, one group, one chunk
    with pytest.raises(RuntimeError, match="vaeunet_bn_relu_f32 failed with CUDA error"):
        _ext.call("bn_relu", fn, cuda, *vector)
    assert torch.equal(bn_relu.fused_bn_relu(x, *st),
                       bn_relu.fused_bn_relu_plain(x, *bn_relu.fold(*st)))


def test_bn_relu_refuses_statistics_it_cannot_read(cuda):
    x = cl(torch.randn((1, 8, 3, 3), device=cuda))
    st = list(stats(8, cuda))
    for bad in (st[0].double(), st[0].cpu(), torch.ones(16, device=cuda)[::2]):
        with pytest.raises(ValueError, match="contiguous float32"):
            bn_relu.fused_bn_relu(x, bad, *st[1:])


# (gx H, W), (g H, W): the logits' 2x upsample, odd up, downsamples by 4, 8
# and 16 (g smaller than gx), H kept, W kept, ragged edges
ROW_BWD_RESIZES = [((16, 24), (32, 48)), ((7, 8), (19, 16)), ((64, 64), (16, 16)),
                   ((128, 128), (16, 16)), ((256, 256), (16, 16)), ((6, 8), (6, 24)),
                   ((9, 16), (20, 16)), ((33, 40), (66, 80)), ((256, 256), (512, 512))]
ROW_BWD_TILES = [None, (1, 1), (4, 2), (16, 8)]       # gx rows x vectors


@pytest.mark.parametrize("in_hw,out_hw", ROW_BWD_RESIZES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_bwd_kernel_equals_the_scalar_kernel_and_the_plain_version(cuda, in_hw, out_hw,
                                                                        ac, dtype):
    """Bit for bit, every tile: the plain version runs on the host, where
    index_add_ adds in index order (on the card it adds with atomics)."""
    esz = 4 if dtype == torch.float32 else 2
    vec = 16 // esz
    assert in_hw[1] % vec == 0                      # gx's row: whole vectors in both types
    g = cl(torch.randn((2, 1, *out_hw), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(7)).to(dtype))
    ref = resize_mm.resize_backward_plain(g.cpu(), in_hw, ac)
    scalar = cl(torch.empty((2, 1, *in_hw), dtype=dtype, device=cuda))
    fn, args = resize_mm.launch_args(g, scalar, ac, backward=True, scalar=True)
    _ext.call("resize", fn, cuda, *args)
    for tile in ROW_BWD_TILES:
        plan = (None if tile is None else
                resize_mm.plan_backward(in_hw, out_hw, 1, esz, ac, 2, tile=(tile[0],
                                                                         tile[1] * vec)))
        if tile is None:
            before = dict(_ext.launch_counts())
            gx = resize_mm.resize_backward(g, in_hw, ac)
            counts = _ext.launch_counts()
            assert counts["resize_bwd"] == before["resize_bwd"] + 1
            assert counts["resize_bwd_row"] == before["resize_bwd_row"] + 1
        else:
            gx = cl(torch.full((2, 1, *in_hw), float("nan"), dtype=dtype, device=cuda))
            fn, args = resize_mm.launch_args(g, gx, ac, backward=True, plan=plan)
            assert "_row_bwd_" in fn
            _ext.call("resize", fn, cuda, *args)
        torch.cuda.synchronize()
        assert torch.equal(gx, scalar), tile
        assert torch.equal(gx.cpu(), ref), tile


def test_a_refused_row_bwd_launch_raises(cuda):
    g = cl(torch.zeros((1, 1, 16, 16), device=cuda))
    gx = cl(torch.zeros((1, 1, 8, 8), device=cuda))
    fn, args = resize_mm.launch_args(g, gx, True, backward=True)
    assert fn == "vaeunet_resize_row_bwd_f32"
    with pytest.raises(RuntimeError, match="vaeunet_resize_row_bwd_f32 failed with CUDA error"):
        _ext.call("resize", fn, cuda, *args[:-1], 400_000)
    # the refusal left nothing behind: the next launch goes through
    assert torch.equal(resize_mm.resize_backward(g, (8, 8), True), gx)


def test_one_channel_resize_gradient_reaches_the_input_through_the_row_route(cuda):
    """The logits' resize in a graph: its gradient takes the row kernel,
    equals the plain gradient on the host bit for bit, and the CPU's
    autograd within fp32 rounding (1e-6, as the other routes' test)."""
    x_cpu = cl(torch.randn((2, 1, 16, 24), generator=torch.Generator().manual_seed(4)))
    x_cpu.requires_grad_()
    x_gpu = x_cpu.detach().to(cuda).requires_grad_()
    w = torch.randn((2, 1, 32, 48), generator=torch.Generator().manual_seed(5))
    before = dict(_ext.launch_counts())
    (resize_bilinear(x_gpu, (32, 48)) * w.to(cuda)).sum().backward()
    (resize_bilinear(x_cpu, (32, 48)) * w).sum().backward()
    counts = _ext.launch_counts()
    assert counts["resize_bwd"] == before["resize_bwd"] + 1
    assert counts["resize_bwd_row"] == before["resize_bwd_row"] + 1
    assert torch.equal(x_gpu.grad.cpu(), resize_mm.resize_backward_plain(w, (16, 24), True))
    torch.testing.assert_close(x_gpu.grad.cpu(), x_cpu.grad, atol=1e-6, rtol=0)
