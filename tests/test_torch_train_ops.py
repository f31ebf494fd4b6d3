"""The training slice's ops against the JAX package on the CPU: the fused
conv + BN-moments op (plain version and the autograd Function's CPU path)
against ``conv3x3_bn_stats`` in interpret mode, the resize gradient against
``jax.grad`` of ``resize_bilinear``, and BatchNorm from moments against the
JAX ``BatchNorm(moments=...)``.  Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vaeunet_tpu.ops.layers import BatchNorm as JaxBatchNorm
from vaeunet_tpu.ops.pallas.conv_bn_stats import conv3x3_bn_stats as jax_conv3x3_bn_stats
from vaeunet_tpu.ops.resize import _interp_matrix, resize_bilinear as jax_resize_bilinear

from vaeunet_tpu_torch.ops import layers
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats, resize_mm


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def oihw(k_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


# ----- conv3x3 + BN moments ------------------------------------------------

CONV_CASES = [((2, 16, 16, 8), 16),       # H a multiple of the JAX row tile
              ((1, 12, 16, 4), 8),        # H = 12: the JAX wrapper's row-padded branch
              ((2, 12, 13, 5), 7)]        # ragged Ci, Co and W


def _conv_inputs(shape, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(3, 3, shape[-1], co) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,co", CONV_CASES)
@pytest.mark.parametrize("which", ["plain", "function"])
def test_conv_bn_stats_forward_matches_pallas_interpret(shape, co, which):
    x, k = _conv_inputs(shape, co, 0)
    ry, rs, rq = jax_conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(k), jnp.float32, 8, True)
    fn = (conv_bn_stats.conv3x3_bn_stats_plain if which == "plain"
          else conv_bn_stats.conv3x3_bn_stats)
    y, s, q = fn(nchw(x), oihw(k))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert s.dtype == q.dtype == torch.float32 and s.shape == q.shape == (co,)
    np.testing.assert_allclose(nhwc(y), np.asarray(ry), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=1e-5, atol=1e-4)


def _moment_loss_jax(y, s, q):
    return jnp.sum(jnp.tanh(y)) + jnp.sum(s * 0.3) + jnp.sum(q * 0.1)


def _moment_loss(y, s, q):
    return torch.tanh(y).sum() + (s * 0.3).sum() + (q * 0.1).sum()


@pytest.mark.parametrize("shape,co", CONV_CASES)
@pytest.mark.parametrize("which", ["plain", "function"])
def test_conv_bn_stats_gradients_match_pallas_interpret(shape, co, which):
    """The tests/test_conv_bn_stats.py:42-45 loss, which reaches y and both
    moments; the Function's backward is the fold + convolution_backward."""
    x, k = _conv_inputs(shape, co, 1)
    gx_ref, gk_ref = jax.grad(
        lambda x, k: _moment_loss_jax(*jax_conv3x3_bn_stats(x, k, jnp.float32, 8, True)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = nchw(x).requires_grad_()
    kt = oihw(k).requires_grad_()
    fn = (conv_bn_stats.conv3x3_bn_stats_plain if which == "plain"
          else conv_bn_stats.conv3x3_bn_stats)
    _moment_loss(*fn(xt, kt)).backward()
    scale_x = np.abs(np.asarray(gx_ref)).max()
    scale_k = np.abs(np.asarray(gk_ref)).max()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx_ref), atol=1e-5 * scale_x)
    np.testing.assert_allclose(kt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gk_ref),
                               atol=1e-5 * scale_k)


def test_conv_bn_stats_missing_cotangents_count_as_zero():
    """A loss that reads only s, or only y, leaves the other cotangents
    None; the fold treats them as 0 and matches the plain autograd."""
    x, k = _conv_inputs((2, 9, 10, 3), 4, 2)
    for pick in (lambda y, s, q: s.sum(), lambda y, s, q: (y * y).sum(),
                 lambda y, s, q: q.sum() * 0.5):
        grads = []
        for fn in (conv_bn_stats.conv3x3_bn_stats, conv_bn_stats.conv3x3_bn_stats_plain):
            xt = nchw(x).requires_grad_()
            kt = oihw(k).requires_grad_()
            pick(*fn(xt, kt)).backward()
            grads.append((xt.grad, kt.grad))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=1e-5 * b.abs().max().item(), rtol=0)


def test_conv_bn_stats_bf16_keeps_fp32_moments():
    x, k = _conv_inputs((1, 8, 8, 4), 6, 3)
    xb, kb = nchw(x).to(torch.bfloat16), oihw(k).to(torch.bfloat16)
    y, s, q = conv_bn_stats.conv3x3_bn_stats(xb, kb)
    ry = F.conv2d(xb.float(), kb.float(), padding=1)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    assert torch.equal(y, ry.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(s, ry.sum(dim=(0, 2, 3)))           # from fp32, not from y
    torch.testing.assert_close(q, (ry * ry).sum(dim=(0, 2, 3)))
    xt = xb.clone().requires_grad_()
    y, s, q = conv_bn_stats.conv3x3_bn_stats(xt, kb)
    (y.float().sum() + s.sum()).backward()
    assert xt.grad.dtype == torch.bfloat16


def test_conv_bn_stats_rejects_what_the_kernel_does_not_take():
    x = nchw(np.zeros((1, 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="channels_last"):
        conv_bn_stats.conv3x3_bn_stats(torch.zeros(1, 3, 4, 5), torch.zeros(2, 3, 3, 3))
    with pytest.raises(ValueError, match="weight must be"):
        conv_bn_stats.conv3x3_bn_stats(x, torch.zeros(2, 3, 5, 5))
    with pytest.raises(ValueError, match="dtype"):
        conv_bn_stats.conv3x3_bn_stats(x, torch.zeros(2, 3, 3, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        conv_bn_stats.conv3x3_bn_stats(x.double(), torch.zeros(2, 3, 3, 3, dtype=torch.float64))


# ----- resize backward -----------------------------------------------------

RESIZE_CASES = [((2, 16, 24, 8), (32, 48)),    # 2x upsample (the decoder's)
                ((1, 7, 5, 3), (19, 12)),      # non-integer ratios
                ((1, 20, 30, 4), (9, 13)),     # downsample
                ((2, 32, 32, 1), (64, 64)),    # C = 1, the logits resize
                ((1, 6, 6, 2), (6, 11))]       # H kept, W resized


@pytest.mark.parametrize("shape,out_hw", RESIZE_CASES)
@pytest.mark.parametrize("ac", [True, False])
def test_resize_backward_plain_matches_jax_grad(shape, out_hw, ac):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[0], *out_hw, shape[3]).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_resize_bilinear(x, out_hw, align_corners=ac), jnp.asarray(x))
    ref, = vjp(jnp.asarray(g))
    ours = resize_mm.resize_backward_plain(nchw(g), shape[1:3], ac)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=1e-5)
    # the CPU wrapper takes the plain version, and autograd through the
    # plain forward gives the same gradient
    np.testing.assert_array_equal(nhwc(resize_mm.resize_backward(nchw(g), shape[1:3], ac)),
                                  nhwc(ours))
    xt = nchw(x).requires_grad_()
    resize_mm.resize(xt, out_hw, ac).backward(nchw(g))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("in_size,out_size,ac", [
    (16, 32, True), (16, 32, False), (7, 19, False), (20, 9, True), (20, 9, False),
    (5, 1, True), (5, 1, False), (6, 6, True), (1, 4, False)])
def test_transpose_tables_are_the_transposed_interp_matrix(in_size, out_size, ac):
    ptr, idx, wt = resize_mm.transpose_table(in_size, out_size, ac)
    assert ptr[0] == 0 and ptr[-1] == idx.size == wt.size == 2 * out_size
    dense = np.zeros((in_size, out_size), np.float32)
    for i in range(in_size):
        np.add.at(dense[i], idx[ptr[i]:ptr[i + 1]], wt[ptr[i]:ptr[i + 1]])
    np.testing.assert_array_equal(dense, _interp_matrix(in_size, out_size, ac).T
                                  if in_size != out_size else np.eye(in_size, dtype=np.float32))


def _kernel_order_backward(g: np.ndarray, in_hw, ac) -> np.ndarray:
    """The CUDA backward kernel's arithmetic in numpy fp32: per input (h, w),
    sum over its column pairs of weight * (sum over its row pairs of
    weight * g), each product and sum rounded, in table order."""
    b, oh, ow, c = g.shape
    hp, hi, hw = resize_mm.transpose_table(in_hw[0], oh, ac)
    wp, wi, ww = resize_mm.transpose_table(in_hw[1], ow, ac)
    out = np.zeros((b, in_hw[0], in_hw[1], c), np.float32)
    for h in range(in_hw[0]):
        for w in range(in_hw[1]):
            acc = np.zeros((b, c), np.float32)
            for k in range(wp[w], wp[w + 1]):
                t = np.zeros((b, c), np.float32)
                for m in range(hp[h], hp[h + 1]):
                    t = t + hw[m] * g[:, hi[m], wi[k], :]
                acc = acc + ww[k] * t
            out[:, h, w, :] = acc
    return out


@pytest.mark.parametrize("ac", [True, False])
def test_resize_backward_kernel_order_equals_the_plain_version(ac):
    """On the CPU ``index_add_`` adds in index order, which is the order
    the kernel sums its tables in: the two agree bit for bit."""
    g = np.random.RandomState(5).randn(2, 13, 10, 3).astype(np.float32)
    for in_hw in ((5, 4), (7, 10), (13, 21)):
        ours = nhwc(resize_mm.resize_backward_plain(nchw(g), in_hw, ac))
        np.testing.assert_array_equal(_kernel_order_backward(g, in_hw, ac), ours)


def test_resize_backward_takes_an_nchw_gradient_and_bf16():
    g = torch.randn(2, 3, 8, 10)
    gx = resize_mm.resize_backward(g, (4, 5), True)
    assert gx.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        gx, resize_mm.resize_backward(g.contiguous(memory_format=torch.channels_last),
                                      (4, 5), True), atol=0, rtol=0)
    gb = resize_mm.resize_backward(g.to(torch.bfloat16), (4, 5), True)
    assert gb.dtype == torch.bfloat16
    assert torch.equal(gb, resize_mm.resize_backward_plain(g.to(torch.bfloat16).float(),
                                                           (4, 5), True).to(torch.bfloat16))


# ----- BatchNorm from moments ----------------------------------------------

def _bn_setup(c, seed):
    rng = np.random.RandomState(seed)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)
    jax_vars = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    bn = layers.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    return jax_vars, bn.train()


def test_batchnorm_from_moments_matches_jax():
    c = 6
    rng = np.random.RandomState(6)
    y = (rng.randn(3, 5, 7, c) * 2 + 1).astype(np.float32)
    y[..., 0] = 0.25                                  # a dead channel: var clamps at 0
    s = y.reshape(-1, c).sum(0)
    q = (y.reshape(-1, c) ** 2).sum(0)
    jax_vars, bn = _bn_setup(c, 7)
    jbn = JaxBatchNorm(c)
    ref, mutated = jbn.apply(jax_vars, jnp.asarray(y), use_running_average=False,
                             moments=(jnp.asarray(s), jnp.asarray(q)), mutable=["batch_stats"])
    out = bn.forward_moments(nchw(y), torch.from_numpy(s), torch.from_numpy(q))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1

    # gradients with respect to y, s, q, scale and bias
    w = rng.randn(*y.shape).astype(np.float32)

    def jloss(y, s, q, params):
        out, _ = jbn.apply({"params": params, "batch_stats": jax_vars["batch_stats"]}, y,
                           use_running_average=False, moments=(s, q), mutable=["batch_stats"])
        return jnp.sum(out * w)

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3))(jnp.asarray(y), jnp.asarray(s), jnp.asarray(q),
                                                 jax_vars["params"])
    yt = nchw(y).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    qt = torch.from_numpy(q).requires_grad_()
    (bn.forward_moments(yt, st, qt) * nchw(w)).sum().backward()
    pairs = [(nhwc(yt.grad), refs[0]), (st.grad.numpy(), refs[1]), (qt.grad.numpy(), refs[2]),
             (bn.weight.grad.numpy(), refs[3]["scale"]), (bn.bias.grad.numpy(), refs[3]["bias"])]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0))


def test_broadcast_latent_bn_matches_jax_virtual_n():
    """The port's z_proj BN runs on the latent broadcast over B x H x W; the
    JAX fused decoder runs it at 1 x 1 with virtual_n = b*h*w.  Same output,
    same running statistics."""
    b, d, h, w = 3, 5, 4, 6
    rng = np.random.RandomState(8)
    zv = rng.randn(b, 1, 1, d).astype(np.float32)
    jax_vars, bn = _bn_setup(d, 9)
    ref, mutated = JaxBatchNorm(d).apply(jax_vars, jnp.asarray(zv), use_running_average=False,
                                         virtual_n=b * h * w, mutable=["batch_stats"])
    out = bn(nchw(np.broadcast_to(zv, (b, h, w, d)).copy()))
    np.testing.assert_allclose(nhwc(out)[:, :1, :1], np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), atol=1e-6)


# ----- layers --------------------------------------------------------------

def test_conv3x3_bn_routes_and_matches_torch_batch_norm():
    torch.manual_seed(0)
    conv = layers.Conv(5, 7, 3, padding=1, bias=False)
    x = torch.randn(2, 5, 9, 11).contiguous(memory_format=torch.channels_last)
    assert conv.takes_bn_stats_kernel()
    assert not layers.Conv(5, 7, 3, stride=2, padding=1, bias=False).takes_bn_stats_kernel()
    assert not layers.Conv(5, 7, 3, padding=1).takes_bn_stats_kernel()
    bn, ref_bn = layers.BatchNorm(7).train(), torch.nn.BatchNorm2d(7).train()
    out = layers.conv3x3_bn(conv, bn, x, relu=True)
    ref = F.relu(ref_bn(F.conv2d(x, conv.weight, padding=1)))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(bn.running_mean, ref_bn.running_mean, atol=1e-6, rtol=0)
    torch.testing.assert_close(bn.running_var, ref_bn.running_var, atol=1e-6, rtol=1e-6)
    bn.eval()     # eval mode: F.conv2d + the bn_relu path, as in serving
    torch.testing.assert_close(layers.conv3x3_bn(conv, bn, x, relu=True),
                               layers.bn_relu(conv(x), bn), atol=0, rtol=0)
    torch.testing.assert_close(layers.conv3x3_bn(conv, bn, x, relu=False), bn(conv(x)),
                               atol=0, rtol=0)


def test_conv_computes_in_the_input_type():
    conv = layers.Conv(4, 3, 1)
    x = torch.randn(1, 4, 5, 5).contiguous(memory_format=torch.channels_last)
    y = conv(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    ref = F.conv2d(x.to(torch.bfloat16), conv.weight.to(torch.bfloat16),
                   conv.bias.to(torch.bfloat16))
    assert torch.equal(y, ref)
    assert conv(x).dtype == torch.float32 and conv.weight.dtype == torch.float32
