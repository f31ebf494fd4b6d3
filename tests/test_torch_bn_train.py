"""Training-mode BN (+ ReLU) from the conv kernel's moments
(``ops/pallas/bn_train.py``) on the CPU: the plain forward against
``BatchNorm.forward_moments`` + ``F.relu`` bit for bit, running statistics
included; the closed-form backward against autograd of those torch ops,
through ``fold_cotangents`` and the conv, and against float64; remat and the
data-parallel group's torch path; the kernels' plans, a numpy model of the
sums pass's thread mapping, the launch arguments against the C entries and
the constants and kernel names of ``csrc/bn_train.cu``.  The kernels run
only on the card (``tests/test_torch_cuda_bn_train.py``).  Inputs come from
seeds."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import _ext, layers, remat
from vaeunet_tpu_torch.ops.pallas import bn_relu, bn_train, conv_bn_stats

SOURCE = (_ext.CSRC / "bn_train.cu").read_text()
CL = torch.channels_last


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


def copy_bn(bn: layers.BatchNorm) -> layers.BatchNorm:
    other = layers.BatchNorm(bn.num_features).train()
    other.load_state_dict(bn.state_dict())
    return other


def conv_input(b, ci, co, h, w, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    conv = layers.Conv(ci, co, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.3)
    x = (torch.randn((b, ci, h, w), generator=g) + 0.5).contiguous(memory_format=CL).to(dtype)
    return conv, x


def old_path(conv, bn, x, relu):
    """The torch ops every site ran before the kernels: the conv kernel's
    (y, s, q), ``forward_moments``, ``F.relu``."""
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x, conv.weight.to(x.dtype))
    out = bn.forward_moments(y, s, q)
    return F.relu(out) if relu else out


CASES = [(dtype, relu, co) for dtype in (torch.float32, torch.bfloat16)
         for relu in (True, False) for co in (16, 6)]


@pytest.mark.parametrize("dtype,relu,co", CASES)
def test_forward_equals_forward_moments_and_relu_bit_for_bit(dtype, relu, co):
    """The site's new forward (one ``bn_train`` node) gives the old path's
    output and running statistics bit for bit; the counter moves once."""
    conv, x = conv_input(2, 5, co, 9, 11, dtype, seed=co)
    bn = make_bn(co, 1)
    ref_bn = copy_bn(bn)
    out = layers.conv3x3_bn(conv, bn, x, relu)
    ref = old_path(conv, ref_bn, x, relu)
    assert type(out.grad_fn).__name__ == "_BnTrainBackward"
    assert out.dtype == dtype and out.is_contiguous(memory_format=CL)
    assert torch.equal(out, ref)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(ref_bn, name)), name
    assert int(bn.num_batches_tracked) == 1


def test_plain_forward_clamps_a_dead_channel():
    """A channel whose q / n - mean^2 rounds below 0 normalizes with var 0
    (the clamp), as ``forward_moments`` does."""
    y = torch.full((2, 3, 4, 5), 0.3).contiguous(memory_format=CL)
    y[:, 1] = torch.randn(2, 4, 5)
    s = y.sum((0, 2, 3))
    q = s * s / 40 - 1e-3                       # var rounds negative in channels 0, 2
    bn = make_bn(3, 2)
    out = bn_train.bn_train_plain(y, s, q, bn.weight, bn.bias, False)
    assert torch.equal(out, copy_bn(bn).forward_moments(y, s, q))
    assert torch.isfinite(out).all()


def grads_of(out, leaves, w):
    return torch.autograd.grad((out.float() * w).sum(), leaves)


@pytest.mark.parametrize("dtype,relu,co", CASES)
def test_backward_through_the_conv_matches_autograd_of_the_old_path(dtype, relu, co):
    """x, conv weight, BN weight and bias gradients of the new site against
    autograd of the old path through ``fold_cotangents`` and the conv.
    fp32: relative L2 1e-5 (the two differ only in fp32 rounding).  bf16:
    dy is rounded once (the old path rounded gy to bf16, then added the
    moments' cotangents and rounded again), so dx moves by about a bf16
    half-ulp of dy over the conv: relative L2 2e-2, and the affine
    gradients, taken before any bf16 rounding, stay at 1e-5."""
    conv, x = conv_input(2, 5, co, 9, 11, dtype, seed=10 + co)
    bn = make_bn(co, 3)
    ref_bn, ref_conv = copy_bn(bn), layers.Conv(5, co, 3, padding=1, bias=False)
    ref_conv.load_state_dict(conv.state_dict())
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = layers.conv3x3_bn(conv, bn, x1, relu)
    ref = old_path(ref_conv, ref_bn, x2, relu)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    ours = grads_of(out, (x1, conv.weight, bn.weight, bn.bias), w)
    theirs = grads_of(ref, (x2, ref_conv.weight, ref_bn.weight, ref_bn.bias), w)
    tols = (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 1e-5)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        a, b = a.double(), b.double()
        rel = float((a - b).norm() / b.norm())
        assert rel <= tols[0 if k < 2 else 1], (k, rel)


def float64_dy(g, y, s, q, weight, bias, relu, eps=1e-5):
    """dy of the torch ops in float64 autograd, y and the mask as given."""
    c = y.shape[1]
    n = y.numel() // c
    y64 = y.double().requires_grad_()
    s64, q64 = y64.sum((0, 2, 3)), (y64 * y64).sum((0, 2, 3))
    mean = s64 / n
    var = torch.clamp(q64 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * weight.double()
    shape = (1, c, 1, 1)
    out = (y64 - mean.view(shape)) * inv.view(shape) + bias.double().view(shape)
    if relu:
        keep = bn_train.bn_train_plain(y, s, q, weight, bias, True) > 0
        out = out * keep
    (dy,) = torch.autograd.grad((out * g.double()).sum(), y64)
    return dy


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("co", [16, 6])
def test_bf16_dy_rounds_once_and_is_nearer_float64(relu, co):
    """In bf16 the closed form's dy differs from the old path's by no more
    than the three roundings between them (the old path's of its direct
    part gy and of its sum, the new one's of dy: half a bf16 ulp each), and
    lies nearer the float64 dy of the same y and mask."""
    g0 = torch.Generator().manual_seed(20 + co)
    y = (torch.randn((4, co, 8, 10), generator=g0) * 2 + 1).to(torch.bfloat16)
    y = y.contiguous(memory_format=CL)
    y32 = y.float()
    s, q = y32.sum((0, 2, 3)), (y32 * y32).sum((0, 2, 3))
    bn = make_bn(co, 5)
    g = torch.randn(y.shape, generator=g0).to(torch.bfloat16).contiguous(memory_format=CL)
    with torch.no_grad():
        dy, _, _ = bn_train.bn_train_backward_plain(g, y, s, q, bn.weight, bn.bias, relu)

    yl, sl, ql = (t.clone().requires_grad_() for t in (y, s, q))
    out = copy_bn(bn).forward_moments(yl, sl, ql)
    out = F.relu(out) if relu else out
    gy, gs, gq = torch.autograd.grad(out, (yl, sl, ql), g)
    old = conv_bn_stats.fold_cotangents(y, gy, gs, gq, torch.bfloat16)

    truth = float64_dy(g, y, s, q, bn.weight, bn.bias, relu)
    half = torch.finfo(torch.bfloat16).eps / 2
    bound = half * (gy.float().abs() + old.float().abs() + dy.float().abs()) * 1.001 + 1e-6
    assert bool(((dy.float() - old.float()).abs() <= bound).all())
    err_new = float((dy.double() - truth).norm())
    err_old = float((old.double() - truth).norm())
    assert err_new <= err_old, (err_new, err_old)


@pytest.mark.parametrize("relu", [True, False])
def test_closed_form_matches_float64_autograd_in_fp32(relu):
    """fp32: the closed form is within fp32 rounding of float64 autograd
    (s and q as y's moments, the mask the forward's), also where the mean
    is large against the spread (the centred sum keeps its digits)."""
    g0 = torch.Generator().manual_seed(7)
    for offset in (0.0, 50.0):
        y = (torch.randn((3, 8, 6, 7), generator=g0) + offset).contiguous(memory_format=CL)
        s, q = y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))
        bn = make_bn(8, 6)
        g = torch.randn(y.shape, generator=g0).contiguous(memory_format=CL)
        with torch.no_grad():
            dy, _, _ = bn_train.bn_train_backward_plain(g, y, s, q, bn.weight, bn.bias, relu)
        truth = float64_dy(g, y, s, q, bn.weight, bn.bias, relu)
        rel = float((dy.double() - truth).norm() / truth.norm())
        assert rel < 1e-5 * (1 + offset), (offset, rel)


@pytest.mark.parametrize("policy", ["full", "save_convs"])
def test_remat_moves_running_statistics_once(policy):
    """Under both remat policies the recompute runs the ``bn_train`` node
    with the statistics frozen: they equal the no-remat run's bit for bit,
    ``num_batches_tracked`` is 1, and the gradients agree."""
    conv, x = conv_input(2, 4, 8, 6, 6, torch.float32, seed=30)
    bn = make_bn(8, 7)
    ref_bn = copy_bn(bn)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()

    def block(t):
        return layers.conv3x3_bn(conv, bn, t, True)

    out = remat.checkpoint(block, x1, policy=policy)
    (out ** 2).sum().backward()
    gx, gw = x1.grad.clone(), bn.weight.grad.clone()
    bn.weight.grad = None
    ref = layers.conv3x3_bn(conv, ref_bn, x2, True)
    (ref ** 2).sum().backward()
    assert int(bn.num_batches_tracked) == 1
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(bn, name), getattr(ref_bn, name)), name
    torch.testing.assert_close(gx, x2.grad, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(gw, ref_bn.weight.grad, atol=1e-6, rtol=1e-5)
    with remat._scope(None, recompute=True):
        before = bn.running_mean.clone()
        layers.conv3x3_bn(conv, bn, x, True)
        assert torch.equal(bn.running_mean, before) and int(bn.num_batches_tracked) == 1


def test_group_batch_norm_keeps_the_torch_path(monkeypatch):
    """With ``BatchNorm.group`` set (the global-batch DP step) the moments
    are summed over the group first, so the site keeps the torch ops: the
    kernels' Function is never called.  The group's sum is stood in for by
    the identity over one rank."""
    def refuse(*a, **k):
        raise AssertionError("bn_train called with a group set")

    monkeypatch.setattr(layers, "bn_train", refuse)
    monkeypatch.setattr(layers, "all_reduce_sum", lambda t, group: t)
    monkeypatch.setattr(layers.dist, "get_world_size", lambda group: 1)
    conv, x = conv_input(2, 4, 8, 6, 6, torch.float32, seed=31)
    bn = make_bn(8, 8)
    ref_bn = copy_bn(bn)
    bn.group = object()
    out = layers.conv3x3_bn(conv, bn, x.requires_grad_(), True)
    assert type(out.grad_fn).__name__ != "_BnTrainBackward"
    assert torch.equal(out, old_path(conv, ref_bn, x, True))


def test_fold_cotangents_passes_gy_through():
    """No moment cotangents and gy already of the type and channels_last:
    gy itself, no copy; otherwise the fold as before."""
    y = torch.randn(2, 8, 3, 5).contiguous(memory_format=CL).to(torch.bfloat16)
    gy = torch.randn(2, 8, 3, 5).contiguous(memory_format=CL).to(torch.bfloat16)
    assert conv_bn_stats.fold_cotangents(y, gy, None, None, torch.bfloat16) is gy
    g32 = gy.float()
    assert conv_bn_stats.fold_cotangents(y.float(), g32, None, None, torch.float32) is g32
    cast = conv_bn_stats.fold_cotangents(y, g32, None, None, torch.bfloat16)
    assert cast is not g32 and torch.equal(cast, gy)
    strided = gy.contiguous()                           # NCHW-contiguous
    out = conv_bn_stats.fold_cotangents(y, strided, None, None, torch.bfloat16)
    assert out.is_contiguous(memory_format=CL) and torch.equal(out, gy)
    gs = torch.randn(8)
    folded = conv_bn_stats.fold_cotangents(y, gy, gs, None, torch.bfloat16)
    assert torch.equal(folded, (gy.float() + gs.view(1, -1, 1, 1)).to(torch.bfloat16))


def test_cpu_path_counts_no_launch_and_checks_its_inputs():
    _ext.reset_launch_counts()
    conv, x = conv_input(1, 3, 8, 4, 4, torch.float32, seed=32)
    layers.conv3x3_bn(conv, make_bn(8, 9), x.requires_grad_(), True).sum().backward()
    counts = _ext.launch_counts()
    assert counts["bn_train_fwd"] == 0 == counts["bn_train_bwd"]
    y = torch.randn(1, 8, 4, 4).contiguous(memory_format=CL)
    v = torch.ones(8)
    with pytest.raises(ValueError, match="contiguous float32"):
        bn_train.bn_train(y, v.double(), v, v, v, True)
    with pytest.raises(ValueError, match="channels_last"):
        bn_train.bn_train(y.contiguous(), v, v, v, v, True)
    with pytest.raises(ValueError, match="non-empty"):
        bn_train.bn_train(y[:0], v, v, v, v, True)


# ----- the kernels' plans, on the CPU --------------------------------------

SMS = 132


@pytest.mark.parametrize("rows,c,elem,aligned,want", [
    # the UNet's widest site [16,64,512,512] bf16: 8 vectors a pixel, 2 blocks an SM
    (16 * 512 * 512, 64, 2, True, ("vector", 8, (8, 32), (264, 1))),
    (16 * 32 * 32, 1024, 2, True, ("vector", 8, (32, 8), (66, 4))),     # its narrowest
    (16 * 16 * 16, 512, 2, True, ("vector", 8, (32, 8), (128, 2))),      # resnet34's: rows run out
    (16 * 256 * 256, 64, 4, True, ("vector", 4, (16, 16), (264, 1))),    # fp32
    (2 * 9 * 11, 6, 2, True, ("scalar", 1, (6, 42), (2, 1))),            # ragged C
    (16 * 64 * 64, 64, 2, False, ("scalar", 1, (32, 8), (132, 2)))])     # off a 16-byte address
def test_reduce_plan_at_the_path_shapes(rows, c, elem, aligned, want):
    assert tuple(bn_train.reduce_plan(rows, c, elem, aligned, SMS)) == want


def sums_model(rows: int, c: int, p: bn_relu.Plan):
    """For each element of a [rows, c] tensor: how many threads of the
    sums pass added it, the channel they added it to, and the partial row
    (block) it went into.  Walks blocks, threads and the row loop as
    bn_train_bwd_reduce_kernel does."""
    adds = np.zeros(rows * c, np.int64)
    channel = np.full(rows * c, -1, np.int64)
    row_of = np.full(rows * c, -1, np.int64)
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
                        idx = r[ok] * c + ch
                        np.add.at(adds, idx, 1)
                        channel[idx] = ch
                        row_of[idx] = block_x
                r0 = r0 + gx * by * u
    return adds, channel, row_of


@pytest.mark.parametrize("rows,c,elem,aligned,sms", [
    (2 * 9 * 11, 6, 2, True, SMS), (4 * 8 * 8, 64, 2, True, 3), (4 * 8 * 8, 64, 4, True, 2),
    (3 * 5 * 7, 24, 2, False, 4), (40, 512, 2, True, 1), (2 * 16 * 16, 16, 4, True, 5)])
def test_the_sums_pass_adds_every_element_once_into_its_channel(rows, c, elem, aligned, sms):
    """Every element is added once, to its own channel, into one of the
    grid's partial rows; with few SMs a block walks many rows."""
    p = bn_train.reduce_plan(rows, c, elem, aligned, sms)
    adds, channel, row_of = sums_model(rows, c, p)
    assert (adds == 1).all()
    assert (channel == np.tile(np.arange(c), rows)).all()
    assert row_of.min() >= 0 and row_of.max() < p.grid[0]
    assert p.block[0] * p.block[1] <= bn_relu.THREADS


def test_the_sums_pass_in_float32_equals_the_closed_form():
    """The kernel's arithmetic in numpy float32, in the kernel's order
    (each thread's rows, the block's rows of threads, the partial rows in
    the last block), then its k0, k1, dweight, dbias and dy: within fp32
    rounding of the plain closed form."""
    rows_hw = (3, 7, 9)
    c = 16
    g0 = torch.Generator().manual_seed(40)
    y = (torch.randn((rows_hw[0], c, *rows_hw[1:]), generator=g0) * 1.5 + 0.3)
    y = y.to(torch.bfloat16).contiguous(memory_format=CL)
    g = torch.randn(y.shape, generator=g0).to(torch.bfloat16).contiguous(memory_format=CL)
    y32 = y.float()
    s, q = y32.sum((0, 2, 3)), (y32 * y32).sum((0, 2, 3))
    bn = make_bn(c, 10)
    with torch.no_grad():
        ref_dy, ref_dw, ref_db = bn_train.bn_train_backward_plain(g, y, s, q, bn.weight,
                                                                  bn.bias, True)
    rows = y.numel() // c
    n = np.float32(rows)
    inv_n = np.float32(1) / n
    f = np.float32
    sn, qn = s.numpy(), q.numpy()
    w, b = bn.weight.detach().numpy(), bn.bias.detach().numpy()
    mean = sn * inv_n
    var_raw = qn * inv_n - mean * mean
    r = f(1) / np.sqrt(np.maximum(var_raw, 0) + f(1e-5))
    inv = r * w
    yf = y32.permute(0, 2, 3, 1).reshape(rows, c).numpy()
    gf = g.float().permute(0, 2, 3, 1).reshape(rows, c).numpy()
    yc = yf - mean
    out = torch.from_numpy(yc * inv + b).to(torch.bfloat16).float().numpy()
    gp = np.where(out <= 0, f(0), gf)
    p = bn_train.reduce_plan(rows, c, 2, True, 2)
    _, _, row_of = sums_model(rows, c, p)
    row_of = row_of.reshape(rows, c)
    partial = np.zeros((p.grid[0], 2, c), np.float32)
    for blk in range(p.grid[0]):
        m = row_of[:, 0] == blk
        partial[blk, 0] = gp[m].sum(0, dtype=np.float32)
        partial[blk, 1] = (gp[m] * yc[m]).sum(0, dtype=np.float32)
    a, bsum = partial[:, 0].sum(0), partial[:, 1].sum(0)
    dvar = f(-0.5) * (bsum * w) * r * r * r
    k0 = -inv * a * inv_n
    k1 = f(2) * np.where(var_raw >= 0, dvar, f(0)) * inv_n
    dy = inv * gp + (k0 + k1 * yc)
    dy = torch.from_numpy(dy.reshape(rows_hw[0], *rows_hw[1:], c)).permute(0, 3, 1, 2)
    torch.testing.assert_close(torch.from_numpy(bsum * r), ref_dw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.from_numpy(a), ref_db, rtol=1e-5, atol=1e-5)
    rel = float((dy.double() - ref_dy.double()).norm() / ref_dy.double().norm())
    assert rel < 4e-3                            # bf16 rounding of ref_dy alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,offset", [(64, 0), (6, 0), (64, 1)])
def test_launch_arguments_fit_the_c_entries(monkeypatch, dtype, c, offset):
    """The forward's and the backward's arguments against the argtypes and
    the source's parameter lists (the stream is appended by
    ``_ext.call``); the running statistics go in as they are, with
    torch's scalars rounded to fp32; the backward's scratch holds k0, k1
    first, then one partial row a block of the sums pass."""
    monkeypatch.setattr(bn_train, "_sms", lambda device: SMS)
    monkeypatch.setattr(bn_train, "tickets",
                        lambda device, chunks: torch.zeros(64, dtype=torch.int32))
    sig = _ext.SIGNATURES["bn_train"]
    params = dict(re.findall(r"^int (vaeunet_bn_(?:train|batch)_\w+)\(([^)]*)\)", SOURCE, re.M))
    assert set(params) == set(sig)
    for name, listed in params.items():
        assert len(listed.split(",")) == len(sig[name]), name
    rows = 2 * 3 * 5
    base = torch.zeros(rows * c + offset, dtype=dtype)
    y = base[offset:].view(2, 3, 5, c).permute(0, 3, 1, 2)
    out = torch.empty_like(y, memory_format=CL)
    v = [torch.full((c,), float(i)) for i in range(4)]
    bn = make_bn(c, 11)
    running = bn._running()
    fn, args = bn_train.forward_launch_args(y, out, *v, True, 1e-5, running)
    tag = "f32" if dtype == torch.float32 else "bf16"
    assert fn == f"vaeunet_bn_train_fwd_{tag}" and len(args) + 1 == len(sig[fn])
    assert args[:9] == (y.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in v),
                        bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
                        bn.num_batches_tracked.data_ptr())
    aligned = (y.data_ptr() | out.data_ptr()) % 16 == 0
    p = bn_relu.plan(rows, c, y.element_size(), aligned)
    assert args[9:14] == (float(np.float32(1) / np.float32(rows)), 1e-5, 0.1, 0.9, rows / (rows - 1))
    assert args[14:] == (rows, c, p.vec, *p.block, *p.grid, 3)
    _, frozen = bn_train.forward_launch_args(y, out, *v, False, 1e-5, None)
    assert frozen[6:9] == (0, 0, 0) and frozen[-1] == 0

    g = torch.zeros_like(out)
    fn, args, (dw, db), (scratch, _) = bn_train.backward_launch_args(g, y, out, *v, True, 1e-5)
    assert fn == f"vaeunet_bn_train_bwd_{tag}" and len(args) + 1 == len(sig[fn])
    aligned = (g.data_ptr() | y.data_ptr() | out.data_ptr()) % 16 == 0
    plan = bn_train.plan(rows, c, y.element_size(), aligned, SMS)
    vector = aligned and c % (16 // y.element_size()) == 0
    assert plan.reduce.route == plan.apply.route == ("vector" if vector else "scalar")
    assert scratch.numel() == (plan.reduce.grid[0] + 1) * 2 * c
    assert args[7] == scratch.data_ptr() + 8 * c and args[9] == scratch.data_ptr()
    assert args[10:12] == (dw.data_ptr(), db.data_ptr())
    assert args[14:] == (rows, c, plan.apply.vec, *plan.reduce.block, *plan.reduce.grid,
                         *plan.apply.block, *plan.apply.grid, 1)


def test_source_constants_and_kernel_names():
    """The source's block size and rows in flight are bn_relu's (their plan
    is shared); the widest vector fits its shared memory; every kernel's
    name starts ``bn_train_`` or ``bn_batch_``, a ``bn_batch_`` name holds
    no ``bn_train_`` (each family's roofline times its own kernels), and
    none holds the names the conv kernel's roofline or the trace's families
    read."""
    assert int(re.search(r"constexpr int kThreads = (\d+);", SOURCE)[1]) == bn_relu.THREADS
    assert (int(re.search(r"constexpr int kRowsInFlight = (\d+);", SOURCE)[1])
            == bn_relu.ROWS_IN_FLIGHT)
    assert int(re.search(r"constexpr int kMaxVec = (\d+);", SOURCE)[1]) == bn_relu.VEC_BYTES // 2
    names = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n(\w+)\(", SOURCE)
    assert sorted(names) == ["bn_batch_bwd_apply_kernel", "bn_batch_bwd_reduce_kernel",
                             "bn_batch_fwd_kernel", "bn_batch_moments_kernel",
                             "bn_train_bwd_apply_kernel", "bn_train_bwd_reduce_kernel",
                             "bn_train_fwd_kernel"]
    for name in names:
        assert "bn_train_" not in name if name.startswith("bn_batch_") else "bn_batch_" not in name
        for taken in ("bn_relu_", "reduce_partials_kernel", "conv3x3_stats", "conv", "copy",
                      "fill", "cat_", "gemm", "batch_norm", "adam", "bn_fw_tr_", "bn_bw_"):
            assert taken not in name, (name, taken)


# ----- the benchmark's reader of the kernels' roofline ---------------------

def load_reader(name: str):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Tracer:
    def __init__(self, seconds):
        self.seconds = seconds

    def seconds_by_name(self):
        return self.seconds


def test_bn_train_roofline_reads_the_byte_bound_over_the_kernels_time():
    """The sites' byte bound (5 passes of the site's tensor plus 32 bytes a
    channel) over the ``bn_train_`` kernels' device time, only with one
    forward launch and one backward call a site in each traced step; a
    program without the counters (the parent) reads nothing."""
    from benchmark.harness.readings import Readings
    reader = load_reader("bn_train_roofline")
    sites = [(16, 3, 512, 512, 64), (16, 64, 256, 256, 128)]
    seconds = {"void (anonymous namespace)::bn_train_fwd_kernel<__nv_bfloat16, 8, true>": 0.003,
               "void (anonymous namespace)::bn_train_bwd_reduce_kernel<...>": 0.002,
               "void (anonymous namespace)::bn_train_bwd_apply_kernel<...>": 0.003,
               "void (anonymous namespace)::conv3x3_stats_wgmma_kernel<128>": 1.0,
               "void (anonymous namespace)::bn_relu_kernel<float, 4>": 1.0}
    r = Readings(kind="train", precision="bf16", tracer=_Tracer(seconds), traced_items=2,
                 conv3x3_sites=sites, counters={"bn_train_fwd": 4, "bn_train_bwd": 4})
    nbytes = sum(5 * n * h * w * co * 2 + 32 * co for n, _, h, w, co in sites)
    assert reader.read(r) == pytest.approx(100 * nbytes / 3.35e12 * 2 / 0.008)
    for counters in ({}, {"bn_train_fwd": 4, "bn_train_bwd": 3}, {"bn_train_fwd": 8,
                                                                   "bn_train_bwd": 4}):
        r.counters = counters
        assert reader.read(r) is None
    r.counters = {"bn_train_fwd": 4, "bn_train_bwd": 4}
    r.kind = "uq"
    assert reader.read(r) is None
    spec = __import__("json").loads((_ext.CSRC.parents[1] / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "bn_train_roofline")
    assert entry["layer"] == "kernels"
    assert entry["moves"] == "train_img_per_s"
    assert set(entry["workloads"]) == {w["name"] for w in spec["workloads"]
                                       if "-train-" in w["name"]}
