"""Training-mode BN (+ ReLU) over a tensor's own batch moments
(``ops/pallas/bn_train.py::bn_batch``) on the CPU: the plain model against
torch's training ``F.batch_norm`` (+ ``F.relu``), forward, running
statistics and backward; the module's route, which keeps torch's ops for
CPU tensors, the data-parallel group and eval mode; the launch arguments
against the C entries of ``csrc/bn_train.cu``.  The kernels run only on the
card (``tests/test_torch_cuda_bn_train.py``).  Inputs come from seeds."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from vaeunet_tpu_torch.ops import _ext, layers, remat
from vaeunet_tpu_torch.ops.pallas import bn_relu, bn_train

SOURCE = (_ext.CSRC / "bn_train.cu").read_text()
CL = torch.channels_last
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_bn(c: int, seed: int) -> layers.BatchNorm:
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn


def make_x(shape, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g) * 1.5 + torch.randn((1, c, 1, 1), generator=g)
    return x.to(dtype).contiguous(memory_format=CL)


# (shape, dtype): the gate's psi (C = 1), a ragged C, the latent's and the
# gates' 32, a bottleneck's 256 and the encoder's last 2048
CASES = [((2, 1, 9, 11), torch.float32), ((3, 3, 5, 7), torch.float32),
         ((2, 32, 6, 6), torch.float32), ((2, 64, 5, 4), torch.bfloat16),
         ((2, 256, 3, 3), torch.bfloat16), ((2, 2048, 2, 2), torch.float32)]


@pytest.mark.parametrize("shape,dtype", CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_plain_model_against_torch_training_batch_norm(shape, dtype, relu):
    """bn_batch on the CPU (its plain model) against ``F.batch_norm`` in
    training mode (+ ``F.relu``) on the same weights: the output within a
    few ulps of x's type plus 1e-4 relative (the variance comes from the
    moments, q / n - mean^2, whose fp32 cancellation at 8 rows a channel
    and |mean| ~ std reaches ~5e-5 of the output; torch sums twice), the
    running statistics within fp32 rounding, the counter moved once, and
    x's, weight's and bias's gradients within the tolerance of two fp32
    evaluations."""
    c = shape[1]
    x = make_x(shape, dtype, seed=c)
    bn, ref = make_bn(c, 3), make_bn(c, 3)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = bn_train.bn_batch(x1, bn.weight, bn.bias, relu, bn.eps, bn._running())
    want = F.batch_norm(x2, ref.running_mean, ref.running_var, ref.weight, ref.bias, True,
                        ref.momentum, ref.eps)
    ref.num_batches_tracked.add_(1)
    want = F.relu(want) if relu else want
    assert out.dtype == dtype and out.is_contiguous(memory_format=CL)
    ulp = torch.finfo(dtype).eps
    torch.testing.assert_close(out.float(), want.float(), rtol=2 * ulp + 1e-4, atol=4 * ulp)
    torch.testing.assert_close(bn.running_mean, ref.running_mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == int(ref.num_batches_tracked) == 1
    g = torch.Generator().manual_seed(c + 1)
    cot = torch.randn(shape, generator=g).to(dtype)
    out.backward(cot)
    want.backward(cot)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = x2.grad.float().abs().max().item()
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), rtol=tol, atol=tol * scale)
    for got, ref_g in ((bn.weight.grad, ref.weight.grad), (bn.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(got, ref_g, rtol=tol, atol=tol * ref_g.abs().max().item())


def test_plain_model_is_bn_train_on_its_own_moments():
    """The forward is ``bn_train_plain`` on x's fp32 sum and sum of squares
    bit for bit, and the backward its closed form, through one node."""
    x = make_x((2, 16, 5, 5), torch.bfloat16, seed=5).requires_grad_()
    bn = make_bn(16, 6)
    out = bn_train.bn_batch(x, bn.weight, bn.bias, True, bn.eps, None)
    assert type(out.grad_fn).__name__ == "_BnBatchBackward"
    s, q = bn_train.batch_moments_plain(x.detach())
    x32 = x.detach().float()
    assert torch.equal(s, x32.sum((0, 2, 3))) and torch.equal(q, (x32 * x32).sum((0, 2, 3)))
    assert torch.equal(out, bn_train.bn_train_plain(x.detach(), s, q, bn.weight, bn.bias, True))
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7)).to(out.dtype)
    out.backward(g)
    dx, dw, db = bn_train.bn_train_backward_plain(g.contiguous(memory_format=CL), x.detach(),
                                                  s, q, bn.weight, bn.bias, True)
    assert torch.equal(x.grad, dx)
    assert torch.equal(bn.weight.grad, dw) and torch.equal(bn.bias.grad, db)


def test_frozen_statistics_and_its_checks():
    """running=None (a remat recompute) leaves the statistics still; an
    NCHW-contiguous input is taken (made channels_last); a channel of one
    value, a float64 input or a weight of the wrong size are refused."""
    bn = make_bn(8, 8)
    before = [t.clone() for t in (bn.running_mean, bn.running_var, bn.num_batches_tracked)]
    x = make_x((2, 8, 3, 3), torch.float32, seed=9)
    out = bn_train.bn_batch(x.contiguous(), bn.weight, bn.bias, False, bn.eps, None)
    assert out.is_contiguous(memory_format=CL)
    assert torch.equal(out, bn_train.bn_batch(x, bn.weight, bn.bias, False, bn.eps, None))
    for a, b in zip(before, (bn.running_mean, bn.running_var, bn.num_batches_tracked)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="more than 1 value"):
        bn_train.bn_batch(x[:1, :, :1, :1], bn.weight, bn.bias, False)
    with pytest.raises(TypeError, match="bn_batch takes float32 or bfloat16"):
        bn_train.bn_batch(x.double(), bn.weight, bn.bias, False)
    with pytest.raises(ValueError, match="bn_batch: weight"):
        bn_train.bn_batch(x, bn.weight[:4], bn.bias, False)


def old_forward(bn: layers.BatchNorm, x: torch.Tensor, relu: bool) -> torch.Tensor:
    y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.training,
                     bn.momentum, bn.eps)
    return F.relu(y) if relu else y


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_cpu_module_keeps_torch_ops(relu, training):
    """A CPU tensor keeps torch's BN (+ a separate ReLU) in both modes, bit
    for bit with the calls the module made before; a training BN counts in
    ``bn_torch`` under a profiler and launches nothing."""
    x = make_x((2, 8, 4, 4), torch.float32, seed=10)
    bn, ref = make_bn(8, 11), make_bn(8, 11)
    bn.train(training)
    ref.train(training)
    _ext.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = bn(x, relu=relu)
    want = old_forward(ref, x, relu)
    assert torch.equal(out, want)
    assert torch.equal(bn.running_mean, ref.running_mean)
    counts = _ext.launch_counts()
    assert counts["bn_torch"] == int(training)
    assert counts["bn_batch_fwd"] == counts["bn_batch_bwd"] == counts["bn_batch_bytes"] == 0


def test_bn_relu_and_the_strided_site_call_the_module_with_the_relu():
    """In training, :func:`layers.bn_relu` and the strided branch of
    :func:`layers.conv3x3_bn` hand the ReLU to the module (one node on the
    card), and forward pre-hooks see the call."""
    seen = []
    bn = make_bn(8, 12)
    bn.register_forward_pre_hook(lambda m, args: seen.append(args[0].shape))
    calls = []
    real = layers.BatchNorm.forward

    def spy(self, x, relu=False):
        calls.append(relu)
        return real(self, x, relu)

    x = make_x((2, 8, 4, 4), torch.float32, seed=13)
    conv = layers.Conv(4, 8, 3, stride=2, padding=1, bias=False)
    x4 = make_x((2, 4, 8, 8), torch.float32, seed=14)
    try:
        layers.BatchNorm.forward = spy
        out = layers.bn_relu(x, bn)
        site = layers.conv3x3_bn(conv, bn, x4, True)
        plain = layers.conv3x3_bn(conv, bn, x4, False)
    finally:
        layers.BatchNorm.forward = real
    assert calls == [True, True, False] and len(seen) == 3
    assert bool((out >= 0).all()) and bool((site >= 0).all()) and bool((plain < 0).any())


def test_group_and_eval_keep_their_paths(monkeypatch):
    """With ``group`` set (the global-batch DP step) the module sums its
    moments over the group in torch ops; in eval mode it runs torch's BN:
    neither calls bn_batch."""
    def refuse(*a, **k):
        raise AssertionError("bn_batch called")

    monkeypatch.setattr(layers, "bn_batch", refuse)
    monkeypatch.setattr(layers, "all_reduce_sum", lambda t, group: t)
    monkeypatch.setattr(layers.dist, "get_world_size", lambda group: 1)
    x = make_x((2, 8, 4, 4), torch.float32, seed=15)
    bn = make_bn(8, 16)
    bn.group = object()
    out = bn(x, relu=True)
    x32 = x.float()
    ref = make_bn(8, 16)
    want = F.relu(ref.forward_moments(x, x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))))
    assert torch.equal(out, want)
    bn.group = None
    bn.eval()
    assert torch.equal(bn(x), old_forward(bn, x, False))


@pytest.mark.parametrize("policy", ["full", "save_convs"])
def test_remat_recompute_moves_the_statistics_once(policy):
    """A strided conv -> BN -> ReLU block under remat: the running
    statistics move once and equal the no-remat run's, gradients agree."""
    conv = layers.Conv(4, 8, 3, stride=2, padding=1, bias=False)
    bn, ref = make_bn(8, 17), make_bn(8, 17)
    x = make_x((2, 4, 8, 8), torch.float32, seed=18)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = remat.checkpoint(lambda t: layers.conv3x3_bn(conv, bn, t, True), x1, policy=policy)
    (out ** 2).sum().backward()
    want = layers.conv3x3_bn(conv, ref, x2, True)
    (want ** 2).sum().backward()
    assert int(bn.num_batches_tracked) == 1
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    torch.testing.assert_close(x1.grad, x2.grad, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,offset", [(64, 0), (6, 0), (64, 1), (1, 0), (2048, 0)])
def test_batch_launch_arguments_fit_the_c_entries(monkeypatch, dtype, c, offset):
    """The forward's and backward's arguments against the argtypes and the
    source's parameter lists; the moments pass takes the backward's sums
    plan, the normalisation bn_relu's; the scratch holds s, q, then one
    partial row a block; the backward reads s and q from it."""
    monkeypatch.setattr(bn_train, "_sms", lambda device: SMS)
    monkeypatch.setattr(bn_train, "tickets",
                        lambda device, chunks: torch.zeros(64, dtype=torch.int32))
    sig = _ext.SIGNATURES["bn_train"]
    params = dict(re.findall(r"^int (vaeunet_bn_batch_\w+)\(([^)]*)\)", SOURCE, re.M))
    assert sorted(params) == sorted(k for k in sig if k.startswith("vaeunet_bn_batch_"))
    for name, listed in params.items():
        assert len(listed.split(",")) == len(sig[name]), name
    rows = 2 * 3 * 5
    base = torch.zeros(rows * c + offset, dtype=dtype)
    x = base[offset:].view(2, 3, 5, c).permute(0, 3, 1, 2)
    out = torch.empty_like(x, memory_format=CL)
    bn = make_bn(c, 19)
    fn, args, scratch = bn_train.batch_forward_launch_args(x, out, bn.weight, bn.bias, True,
                                                           1e-5, bn._running())
    tag = "f32" if dtype == torch.float32 else "bf16"
    assert fn == f"vaeunet_bn_batch_fwd_{tag}" and len(args) + 1 == len(sig[fn])
    aligned = (x.data_ptr() | out.data_ptr()) % 16 == 0
    p = bn_train.plan(rows, c, x.element_size(), aligned, SMS)
    assert scratch.numel() == (p.reduce.grid[0] + 1) * 2 * c
    base = scratch.data_ptr()
    assert args[:10] == (x.data_ptr(), out.data_ptr(), base, base + 8 * c, args[4],
                         bn.weight.data_ptr(), bn.bias.data_ptr(), bn.running_mean.data_ptr(),
                         bn.running_var.data_ptr(), bn.num_batches_tracked.data_ptr())
    assert args[10:15] == (float(np.float32(1) / np.float32(rows)), 1e-5, 0.1, 0.9,
                           rows / (rows - 1))
    assert args[15:] == (rows, c, p.apply.vec, *p.reduce.block, *p.reduce.grid,
                         *p.apply.block, *p.apply.grid, 3)
    _, frozen, _ = bn_train.batch_forward_launch_args(x, out, bn.weight, bn.bias, False, 1e-5,
                                                      None)
    assert frozen[7:10] == (0, 0, 0) and frozen[-1] == 0

    g = torch.zeros_like(out)
    fn, args, (dw, db), _ = bn_train.batch_backward_launch_args(g, out, out, scratch, bn.weight,
                                                                bn.bias, True, 1e-5)
    assert fn == f"vaeunet_bn_batch_bwd_{tag}" and len(args) + 1 == len(sig[fn])
    assert args[3:5] == (base, base + 4 * c)
    _, train_args, _, _ = bn_train.backward_launch_args(g, out, out, scratch[:c],
                                                        scratch[c:2 * c], bn.weight, bn.bias,
                                                        True, 1e-5)
    assert args[:7] == train_args[:7] and args[12:] == train_args[12:]


@pytest.mark.parametrize("rows,c,elem,aligned", [
    (32 * 128 * 128, 256, 2, True), (16 * 512 * 512, 1, 2, True), (16 * 512 * 512, 32, 2, True),
    (32 * 16 * 16, 2048, 2, True), (32 * 256 * 256, 64, 2, True)])
def test_moments_plan_at_the_path_shapes(rows, c, elem, aligned):
    """At the sites' shapes (a resnet50 bn3, the UNet gate's psi and its
    32-wide BNs, the encoder's last stage, the stem) the moments pass
    covers every channel with at most two blocks an SM, each with rows to
    read, and the normalisation covers every row, within the grid's
    limits."""
    p = bn_train.plan(rows, c, elem, aligned, SMS)
    assert p.reduce.route == p.apply.route == ("vector" if c % 8 == 0 else "scalar")
    bx, by = p.reduce.block
    assert bx * by <= bn_relu.THREADS and bx * p.reduce.grid[1] * p.reduce.vec >= c
    assert p.reduce.grid[0] * p.reduce.grid[1] <= 2 * SMS + p.reduce.grid[1]
    assert (p.reduce.grid[0] - 1) * by * bn_relu.ROWS_IN_FLIGHT < rows
    ax, ay = p.apply.block
    assert p.apply.grid[0] * ay * bn_relu.ROWS_IN_FLIGHT >= rows


@pytest.mark.parametrize("rows,c,elem,aligned,sms", [
    (2 * 9 * 11, 6, 2, True, 132), (4 * 8 * 8, 64, 2, True, 3), (3 * 5 * 7, 24, 2, False, 4),
    (40, 512, 2, True, 1), (2 * 16 * 16, 16, 4, True, 5), (7 * 13, 1, 2, True, 2)])
def test_the_moments_pass_reads_every_element_once(rows, c, elem, aligned, sms):
    """A model of the moments kernel's walk (blocks, threads,
    ``ROWS_IN_FLIGHT`` rows a step, as the sums pass of the backward):
    every element is added once, to its own channel, into one of the
    grid's partial rows."""
    p = bn_train.plan(rows, c, elem, aligned, sms).reduce
    adds = np.zeros(rows * c, np.int64)
    channel = np.full(rows * c, -1, np.int64)
    vecs = c // p.vec
    (bx, by), (gx, gy) = p.block, p.grid
    u = bn_relu.ROWS_IN_FLIGHT
    tx, ty = np.meshgrid(np.arange(bx), np.arange(by), indexing="ij")
    tx, ty = tx.ravel(), ty.ravel()
    for block_y in range(gy):
        v = block_y * bx + tx
        live = v < vecs
        for block_x in range(gx):
            r0 = block_x * by * u + ty
            while (live & (r0 < rows)).any():
                for k in range(u):
                    r = r0 + k * by
                    ok = live & (r < rows)
                    for j in range(p.vec):
                        ch = v[ok] * p.vec + j
                        np.add.at(adds, r[ok] * c + ch, 1)
                        channel[r[ok] * c + ch] = ch
                r0 = r0 + gx * by * u
    assert (adds == 1).all()
    assert (channel == np.tile(np.arange(c), rows)).all()
