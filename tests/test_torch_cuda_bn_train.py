"""The training BN (+ ReLU) kernels (``csrc/bn_train.cu``) on the card: at
every site shape of the two training cells (512^2, batch 16, bf16) the
forward equals the plain version on the card bit for bit, running
statistics included, and the backward is within its tolerance of the plain
closed form and bit-identical across runs; the routes, a call's device
kernels, the sites' counts in a step, and the conv + BN site against the
torch ops it replaced.  The same for the ``bn_batch_`` family (the BNs off
the fused sites): its moments against fp32 sums, its forward against the
plain version on its own moments bit for bit, its backward against the
closed form and against autograd of torch's training BN; its SiLU at the
EfficientNet-B4 cell's shapes against ``F.batch_norm`` + ``F.silu``.  The
kernels a depthwise conv launches, forward and backward, against the names
``benchmark/metrics/dwconv_roofline.py`` reads, which a dense 3x3 conv's
kernels must not match.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_cuda_bn_train.py -m cuda --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch import use_fp32_numerics
from vaeunet_tpu_torch.ops import _ext, layers, remat
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv, conv3x3_bn
from vaeunet_tpu_torch.ops.pallas import bn_relu, bn_train, conv_bn_stats
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

pytestmark = pytest.mark.cuda

CL = torch.channels_last

# (C, H = W, relu) of the sites of the two training cells at 512^2: the
# plain UNet's 18 and the resnet34 VAE-UNet's 37 (a basic block's second
# conv has no ReLU)
UNET_SITES = [(64, 512, True), (128, 256, True), (256, 128, True), (512, 64, True),
              (1024, 32, True)]
R34_SITES = [(64, 256, True), (64, 128, True), (64, 128, False), (128, 128, True),
             (128, 64, True), (128, 64, False), (256, 64, True), (256, 32, True),
             (256, 32, False), (512, 32, True), (512, 16, True), (512, 16, False)]
SITES = sorted(set(UNET_SITES) | set(R34_SITES))
BATCH = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


def inputs(shape, dtype, device, seed: int = 0, offset: int = 0):
    """y (channels_last; `offset` elements past a 16-byte address), its
    fp32 moments, the cotangent, a BatchNorm's affine parameters and
    running statistics."""
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.empty(n * h * w * c + offset, device=device, dtype=dtype)
    y = base[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    y.copy_((torch.randn(shape, device=device, generator=g) * 1.5
             + torch.randn((1, c, 1, 1), device=device, generator=g)).to(dtype))
    y32 = y.float()
    s, q = y32.sum((0, 2, 3)), (y32 * y32).sum((0, 2, 3))
    grad = torch.randn(shape, device=device, generator=g).to(dtype).contiguous(memory_format=CL)
    bn = BatchNorm(c).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, device=device, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, device=device, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(c, device=device, generator=g))
        bn.running_var.copy_(torch.rand(c, device=device, generator=g) + 0.5)
    return y, s, q, grad, bn


def check_forward(y, s, q, bn, relu):
    """Kernel and plain version on the card, both moving a copy of the
    running statistics: equal bit for bit."""
    ours = bn._running()
    ref = bn_train.Running(ours.mean.clone(), ours.var.clone(), ours.count.clone(),
                           ours.momentum)
    before = _ext.launch_counts()["bn_train_fwd"]
    with torch.no_grad():
        out = bn_train.bn_train(y, s, q, bn.weight, bn.bias, relu, bn.eps, ours)
        want = bn_train.bn_train_plain(y, s, q, bn.weight, bn.bias, relu, bn.eps, ref)
    torch.cuda.synchronize()
    assert _ext.launch_counts()["bn_train_fwd"] == before + 1
    assert out.dtype == y.dtype and out.is_contiguous(memory_format=CL)
    assert torch.equal(out, want)
    assert torch.equal(ours.mean, ref.mean) and torch.equal(ours.var, ref.var)
    assert int(ours.count) == int(ref.count) == 1


def backward(y, s, q, grad, bn, relu):
    dy = torch.empty_like(y, memory_format=CL)
    fn, args, (dw, db), keep = bn_train.backward_launch_args(grad, y, dy, s, q, bn.weight,
                                                             bn.bias, relu, bn.eps)
    _ext.call("bn_train", fn, y.device, *args)
    return dy, dw.clone(), db.clone()


def check_backward(y, s, q, grad, bn, relu):
    """Within the tolerance of two fp32 evaluations of the closed form
    rounded once: a bf16 (or fp32) ulp of dy, plus 1e-5 of the largest of
    dy and inv g (the terms that cancel in dy = inv g' + k0 + k1 (y - mean):
    with one row they cancel to 0, up to the fp32 rounding of inv g');
    dweight and dbias, sums over the rows in another order, 1e-4.  Two
    runs: the same bits."""
    with torch.no_grad():
        want = bn_train.bn_train_backward_plain(grad, y, s, q, bn.weight, bn.bias, relu, bn.eps)
    first = backward(y, s, q, grad, bn, relu)
    second = backward(y, s, q, grad, bn, relu)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    dy, dw, db = first
    ulp = torch.finfo(y.dtype).eps
    _, _, inv = bn_train.fold_moments(s, q, y.numel() // y.shape[1], bn.eps, bn.weight)
    top = max(want[0].float().abs().max().item(),
              inv.abs().max().item() * grad.float().abs().max().item())
    torch.testing.assert_close(dy.float(), want[0].float(), rtol=ulp, atol=1e-5 * top)
    for got, ref in ((dw, want[1]), (db, want[2])):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("c,hw,relu", SITES)
def test_sites_forward_bit_for_bit_backward_within_tolerance(cuda, c, hw, relu):
    y, s, q, grad, bn = inputs((BATCH, c, hw, hw), torch.bfloat16, cuda, seed=c + hw)
    check_forward(y, s, q, bn, relu)
    check_backward(y, s, q, grad, bn, relu)


# fp32 (amp=False), ragged C (scalar route), C = 2048 (the sums pass in
# eight chunks on the scalar route, two on the vector one), a view off a
# 16-byte address, one row
SMALL = [((2, 64, 16, 16), torch.float32, 0), ((2, 6, 5, 7), torch.float32, 0),
         ((2, 6, 5, 7), torch.bfloat16, 0), ((3, 12, 4, 9), torch.bfloat16, 0),
         ((3, 12, 4, 9), torch.float32, 0), ((2, 2048, 4, 4), torch.bfloat16, 0),
         ((2, 2048, 4, 4), torch.float32, 1), ((4, 64, 8, 8), torch.bfloat16, 1),
         ((1, 32, 1, 1), torch.float32, 0)]


@pytest.mark.parametrize("shape,dtype,offset", SMALL)
@pytest.mark.parametrize("relu", [True, False])
def test_routes_fp32_ragged_and_offset(cuda, shape, dtype, offset, relu):
    y, s, q, grad, bn = inputs(shape, dtype, cuda, seed=shape[1], offset=offset)
    vec = 16 // y.element_size()
    aligned = y.data_ptr() % 16 == 0
    assert bn_relu.plan(y.numel() // shape[1], shape[1], y.element_size(), aligned).route == (
        "vector" if aligned and shape[1] % vec == 0 else "scalar")
    check_forward(y, s, q, bn, relu)
    check_backward(y.contiguous(memory_format=CL), s, q, grad, bn, relu)


def test_frozen_statistics_stay(cuda):
    y, s, q, _, bn = inputs((2, 64, 8, 8), torch.bfloat16, cuda)
    before = [t.clone() for t in (bn.running_mean, bn.running_var, bn.num_batches_tracked)]
    with torch.no_grad():
        bn_train.bn_train(y, s, q, bn.weight, bn.bias, True, bn.eps, None)
    torch.cuda.synchronize()
    for a, b in zip(before, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        assert torch.equal(a, b)


def test_one_call_forward_one_backward_no_torch_compute(cuda, monkeypatch):
    """A forward is one C call (one launch), a backward one (its two
    launches); around them no torch op but allocations and views runs.
    (Read from the calls and the dispatcher, not from a profiler session:
    a second session in one process loses the first launches of ctypes
    kernels, which would fail the profiler tests of other files.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    calls = []
    real = _ext.call
    monkeypatch.setattr(_ext, "call", lambda lib, fn, *a: (calls.append(fn), real(lib, fn, *a)))
    y, s, q, grad, bn = inputs((4, 64, 32, 32), torch.bfloat16, cuda)
    bn_train.bn_train(y, s, q, bn.weight, bn.bias, True, bn.eps, bn._running())
    bn_train._backward_cuda(grad, y, s, q, bn.weight, bn.bias, True, bn.eps)
    calls.clear()
    with Ops() as fwd_ops:
        bn_train.bn_train(y, s, q, bn.weight, bn.bias, True, bn.eps, bn._running())
    with Ops() as bwd_ops:
        bn_train._backward_cuda(grad, y, s, q, bn.weight, bn.bias, True, bn.eps)
    torch.cuda.synchronize()
    assert calls == ["vaeunet_bn_train_fwd_bf16", "vaeunet_bn_train_bwd_bf16"]
    allocations = {"empty", "empty_like", "empty_strided", "select", "zeros"}
    assert set(fwd_ops.names) <= allocations and set(bwd_ops.names) <= allocations, (
        fwd_ops.names, bwd_ops.names)
    source = (_ext.CSRC / "bn_train.cu").read_text()
    # the forward's launch and the backward's two, of each family (the
    # bn_batch_ forward adds its moments pass)
    assert source.count("bn_train_fwd_kernel<T, V, kAct><<<") == 1
    assert source.count("<<<") == 3 + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_site_against_the_torch_ops_it_replaced(cuda, dtype, relu):
    """conv3x3_bn on the card: the output and running statistics of the
    conv kernel + ``forward_moments`` + ``F.relu`` on the card bit for bit;
    the gradients of x, the conv weight and the affine parameters within
    relative L2 1e-5 in fp32, 2e-2 in bf16 for x and the conv weight (dy is
    rounded once, where autograd rounded twice)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    conv = Conv(24, 32, 3, padding=1, bias=False).to(cuda)
    x = torch.randn((4, 24, 20, 24), device=cuda, generator=g).to(dtype)
    x = x.contiguous(memory_format=CL)
    bn = BatchNorm(32).to(cuda).train()
    ref_bn = BatchNorm(32).to(cuda).train()
    ref_bn.load_state_dict(bn.state_dict())
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = conv3x3_bn(conv, bn, x1, relu)
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x2, conv.weight.to(dtype))
    ref = ref_bn.forward_moments(y, s, q)
    ref = F.relu(ref) if relu else ref
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(bn.running_mean, ref_bn.running_mean)
    assert torch.equal(bn.running_var, ref_bn.running_var)
    w = torch.randn(out.shape, device=cuda, generator=g)
    ours = torch.autograd.grad((out.float() * w).sum(), (x1, conv.weight, bn.weight, bn.bias))
    theirs = torch.autograd.grad((ref.float() * w).sum(),
                                 (x2, conv.weight, ref_bn.weight, ref_bn.bias))
    for k, (a, b) in enumerate(zip(ours, theirs)):
        tol = 1e-5 if dtype == torch.float32 or k >= 2 else 2e-2
        rel = ((a.double() - b.double()).norm() / b.double().norm()).item()
        assert rel <= tol, (k, rel)


@pytest.mark.parametrize("kind,sites", [("unet", 18), ("resnet34", 37)])
def test_a_step_runs_one_forward_and_one_backward_a_site(cuda, kind, sites):
    """The two training cells' models (64^2, batch 2, bf16): every site
    takes the kernels once forward and once backward; every parameter's
    gradient is finite."""
    fields = dict(unet=dict(model_type="basic"),
                  resnet34=dict(model_type="resnet", backbone="resnet34"))[kind]
    config = TrainConfig(batch_size=2, gradient_accumulation_steps=1, patch_size=64, amp=True,
                         **fields)
    state = create_train_state(config, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    images = torch.rand((2, 64, 64, 3), device=cuda, generator=g)
    masks = (torch.rand((2, 64, 64, 1), device=cuda, generator=g) > 0.9).float()
    _ext.reset_launch_counts()
    make_train_step(config, state.model).compute_gradients(state, images, masks, 0.001)
    torch.cuda.synchronize()
    counts = _ext.launch_counts()
    assert counts["bn_train_fwd"] == counts["bn_train_bwd"] == sites, counts
    assert counts["conv_bn_stats"] + counts["conv_bn_stats_ci8"] == sites, counts
    for name, p in state.model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


# ----- bn_batch: training BN over the tensor's own moments -------------------

def batch_forward(x, bn, relu, running):
    """The forward's C call alone: (out, s, q)."""
    out, moments = bn_train._batch_forward_cuda(x, bn.weight, bn.bias, relu, bn.eps, running)
    c = x.shape[1]
    return out, moments[:c], moments[c:2 * c], moments


def check_batch(x, grad, bn, relu):
    """Moments within fp32 summation of x's own sums; the forward bit for
    bit the plain version on those moments (running statistics and the
    counter included); the backward bit for bit across runs and within
    ``check_backward``'s tolerance of the closed form; against autograd of
    torch's training BN (+ ReLU), relative L2 1e-4 in fp32 and 2e-2 in
    bf16 (a few elements near 0 may fall on the other side of the ReLU;
    torch's SiLU backward rounds g' to bf16, the kernel keeps it in fp32).
    `relu` is the activation: False, True or ``bn_train.SILU``."""
    c = x.shape[1]
    ours = bn._running()
    ref = bn_train.Running(ours.mean.clone(), ours.var.clone(), ours.count.clone(),
                           ours.momentum)
    before = _ext.launch_counts()["bn_batch_fwd"]
    out, s, q, moments = batch_forward(x, bn, relu, ours)
    torch.cuda.synchronize()
    assert _ext.launch_counts()["bn_batch_fwd"] == before + 1
    x32 = x.float()
    for got, want, mag in ((s, x32.sum((0, 2, 3)), x32.abs().sum((0, 2, 3))),
                           (q, (x32 * x32).sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)))):
        assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all()), (got - want).abs().max()
    want = bn_train.bn_train_plain(x, s.clone(), q.clone(), bn.weight, bn.bias, relu, bn.eps,
                                   ref)
    assert out.dtype == x.dtype and out.is_contiguous(memory_format=CL)
    assert torch.equal(out, want)
    assert torch.equal(ours.mean, ref.mean) and torch.equal(ours.var, ref.var)
    assert int(ours.count) == int(ref.count) == 1

    def run():
        return bn_train._batch_backward_cuda(grad, x, moments, bn.weight, bn.bias, relu, bn.eps)

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    dx, dw, db = first
    with torch.no_grad():
        plain = bn_train.bn_train_backward_plain(grad, x, s, q, bn.weight, bn.bias, relu, bn.eps)
    ulp = torch.finfo(x.dtype).eps
    _, _, inv = bn_train.fold_moments(s, q, x.numel() // c, bn.eps, bn.weight)
    top = max(plain[0].float().abs().max().item(),
              inv.abs().max().item() * grad.float().abs().max().item())
    torch.testing.assert_close(dx.float(), plain[0].float(), rtol=ulp, atol=1e-5 * top)
    for got, want in ((dw, plain[1]), (db, plain[2])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())

    x2 = x.clone().requires_grad_()
    w2, b2 = bn.weight.detach().clone().requires_grad_(), bn.bias.detach().clone().requires_grad_()
    y2 = F.batch_norm(x2, None, None, w2, b2, True, 0.1, bn.eps)
    y2 = bn_train.activate_plain(y2, relu)
    theirs = torch.autograd.grad(y2, (x2, w2, b2), grad)
    tol = 1e-4 if x.dtype == torch.float32 else 2e-2
    for k, (a, b) in enumerate(zip((dx, dw, db), theirs)):
        rel = ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()
        assert rel <= tol, (k, rel)


def batch_inputs(shape, dtype, device, seed: int = 0, offset: int = 0):
    x, _, _, grad, bn = inputs(shape, dtype, device, seed=seed, offset=offset)
    return x, grad, bn


# C = 1 (the gate's psi), 3 (ragged: the scalar route), 32 (the latent and
# the UNet's gates), 64, 256 and 2048 (the resnet50 encoder), at ragged rows
BATCH_SMALL = [((4, c, 13, 11), dtype, 0) for c in (1, 3, 32, 64, 256, 2048)
               for dtype in (torch.float32, torch.bfloat16)]
BATCH_SMALL += [((4, 64, 13, 11), torch.bfloat16, 1), ((3, 32, 7, 5), torch.float32, 1)]


@pytest.mark.parametrize("shape,dtype,offset", BATCH_SMALL)
@pytest.mark.parametrize("relu", [True, False])
def test_bn_batch_moments_forward_backward(cuda, shape, dtype, offset, relu):
    x, grad, bn = batch_inputs(shape, dtype, cuda, seed=shape[1] + offset, offset=offset)
    aligned = x.data_ptr() % 16 == 0
    route = bn_relu.plan(x.numel() // shape[1], shape[1], x.element_size(), aligned).route
    assert route == ("vector" if aligned and shape[1] % (16 // x.element_size()) == 0
                     else "scalar")
    if offset:
        # an offset view that is still channels_last: the wrapper launches it as it is
        assert x.is_contiguous(memory_format=CL) and route == "scalar"
    check_batch(x, grad, bn, relu)


# the path's shapes: a resnet50 bn3 at batch 32, a UNet gate's 32-wide BN
# and its psi at batch 16
BATCH_SITES = [((32, 256, 128, 128), True), ((16, 32, 512, 512), False),
               ((16, 1, 512, 512), False)]


@pytest.mark.parametrize("shape,relu", BATCH_SITES)
def test_bn_batch_at_the_site_shapes(cuda, shape, relu):
    x, grad, bn = batch_inputs(shape, torch.bfloat16, cuda, seed=7)
    check_batch(x, grad, bn, relu)


# the EfficientNet-B4 cell's BN + SiLU sites at 512^2, batch 32: the first
# expansion at 256^2, a stage-1 expansion at 128^2, the widest at 16^2
SILU_SITES = [(32, 144, 256, 256), (32, 192, 128, 128), (32, 1632, 16, 16)]


@pytest.mark.parametrize("shape", SILU_SITES)
def test_bn_batch_silu_at_the_effb4_shapes(cuda, shape):
    x, grad, bn = batch_inputs(shape, torch.bfloat16, cuda, seed=11)
    before = _ext.launch_counts()["bn_batch_silu"]
    check_batch(x, grad, bn, bn_train.SILU)
    assert _ext.launch_counts()["bn_batch_silu"] == before + 1


@pytest.mark.parametrize("shape,dtype,offset", BATCH_SMALL[::3])
def test_bn_batch_silu_routes(cuda, shape, dtype, offset):
    x, grad, bn = batch_inputs(shape, dtype, cuda, seed=shape[1] + offset, offset=offset)
    check_batch(x, grad, bn, bn_train.SILU)


def test_bn_train_refuses_the_silu(cuda):
    """The fused sites' entries have no SiLU kernel: flag 4 is refused."""
    y, s, q, _, bn = inputs((2, 64, 8, 8), torch.bfloat16, cuda)
    out = torch.empty_like(y)
    fn, args = bn_train.forward_launch_args(y, out, s, q, bn.weight, bn.bias, False, bn.eps, None)
    with pytest.raises(RuntimeError):
        _ext.call("bn_train", fn, y.device, *args[:-1], 4)


def dwconv_kernels():
    from benchmark.harness.registry import load_module

    return load_module(__import__("pathlib").Path(__file__).resolve().parents[1] / "benchmark"
                       / "metrics" / "dwconv_roofline.py", "dwconv_roofline").KERNELS


def device_kernel_names(fn) -> set:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


def conv_forward_backward(shape, weight, stride, padding, groups):
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=CL).requires_grad_()
    w = weight.to(torch.bfloat16).contiguous(memory_format=CL).requires_grad_()
    y = F.conv2d(x, w, None, stride, padding, 1, groups)
    gy = torch.randn(y.shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=CL)

    def run():
        out = F.conv2d(x, w, None, stride, padding, 1, groups)
        torch.autograd.grad(out, (x, w), gy)
    return run


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2)])
def test_dwconv_kernels_are_the_roofline_readers(cuda, k, stride):
    """A depthwise conv's forward and backward at [32, 192, 128, 128] (bf16,
    channels_last) launch only kernels whose names hold one of
    ``dwconv_roofline``'s fragments."""
    names = dwconv_kernels()
    w = torch.randn((192, 1, k, k), device="cuda")
    launched = device_kernel_names(conv_forward_backward((32, 192, 128, 128), w, stride,
                                                         k // 2, 192))
    assert launched and all(any(f in n for f in names) for n in launched), launched


def test_dense_conv_kernels_are_not_the_roofline_readers(cuda):
    names = dwconv_kernels()
    w = torch.randn((64, 64, 3, 3), device="cuda")
    launched = device_kernel_names(conv_forward_backward((16, 64, 256, 256), w, 1, 1, 1))
    assert launched and not any(f in n for f in names for n in launched), launched


def test_bn_batch_module_route_and_frozen_statistics(cuda, monkeypatch):
    """A training BatchNorm on the card is one bn_batch node, the ReLU
    inside; under a remat recompute its statistics stay; eval mode and a
    set ``group`` keep torch's ops."""
    x, _, bn = batch_inputs((2, 64, 8, 8), torch.bfloat16, cuda)
    x.requires_grad_()
    out = bn(x, relu=True)
    assert type(out.grad_fn).__name__ == "_BnBatchBackward" and bool((out >= 0).all())
    assert int(bn.num_batches_tracked) == 1
    before = [t.clone() for t in (bn.running_mean, bn.running_var, bn.num_batches_tracked)]
    calls = _ext.launch_counts()["bn_batch_fwd"]
    with remat._scope(None, recompute=True):
        bn(x)
    torch.cuda.synchronize()
    assert _ext.launch_counts()["bn_batch_fwd"] == calls + 1
    for a, b in zip(before, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        assert torch.equal(a, b)
    with torch.no_grad():
        bn_train.bn_batch(x, bn.weight, bn.bias, True, bn.eps, None)
    torch.cuda.synchronize()
    for a, b in zip(before, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        assert torch.equal(a, b)
    monkeypatch.setattr(layers, "all_reduce_sum", lambda t, group: t)
    monkeypatch.setattr(layers.dist, "get_world_size", lambda group: 1)
    bn.group = object()
    assert type(bn(x).grad_fn).__name__ != "_BnBatchBackward"
    bn.group = None
    bn.eval()
    assert type(bn(x).grad_fn).__name__ != "_BnBatchBackward"


def test_bn_batch_one_call_each_way_no_torch_compute(cuda, monkeypatch):
    """A forward is one C call (two launches), a backward one (two);
    around them no torch op but allocations and views runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    calls = []
    real = _ext.call
    monkeypatch.setattr(_ext, "call", lambda lib, fn, *a: (calls.append(fn), real(lib, fn, *a)))
    x, grad, bn = batch_inputs((4, 64, 32, 32), torch.bfloat16, cuda)
    out, moments = bn_train._batch_forward_cuda(x, bn.weight, bn.bias, True, bn.eps,
                                                bn._running())
    bn_train._batch_backward_cuda(grad, x, moments, bn.weight, bn.bias, True, bn.eps)
    calls.clear()
    with Ops() as fwd_ops:
        bn_train.bn_batch(x, bn.weight, bn.bias, True, bn.eps, bn._running())
    with Ops() as bwd_ops:
        bn_train._batch_backward_cuda(grad, x, moments, bn.weight, bn.bias, True, bn.eps)
    torch.cuda.synchronize()
    assert calls == ["vaeunet_bn_batch_fwd_bf16", "vaeunet_bn_batch_bwd_bf16"]
    allocations = {"empty", "empty_like", "empty_strided", "select", "zeros"}
    assert set(fwd_ops.names) <= allocations and set(bwd_ops.names) <= allocations, (
        fwd_ops.names, bwd_ops.names)
