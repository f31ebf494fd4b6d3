"""Port ops against the JAX package on the CPU: the kernels' plain versions
(fused BN+ReLU, resize, noise, reparameterization), resize conventions,
pools and the sampling guard.  Inputs come from numpy seeds; the JAX Pallas
kernels run in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaeunet_tpu.ops.pallas.bn_relu import fused_bn_relu as jax_fused_bn_relu
from vaeunet_tpu.ops.pallas import resize_mm as jax_resize_mm
from vaeunet_tpu.ops.pool import avg_pool_global as jax_avg_pool, max_pool as jax_max_pool
from vaeunet_tpu.ops.resize import (
    _interp_matrix,
    resize_bilinear as jax_resize_bilinear,
    resize_nearest as jax_resize_nearest,
)
from vaeunet_tpu.vae_utils import sample_latents as jax_sample_latents

from vaeunet_tpu_torch.ops import pool, resize
from vaeunet_tpu_torch.ops.pallas import bn_relu, reparam, resize_mm
from vaeunet_tpu_torch.ops.sampling import gaussian_like
from vaeunet_tpu_torch.vae_utils import LOGVAR_GUARD, sample_latents


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last torch (a view of the same layout)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# ----- fused BN + ReLU -----------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 9, 9, 16), (3, 7, 5, 8)])   # 105 rows: not tile-aligned
def test_bn_relu_plain_matches_pallas_interpret(shape):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = rng.rand(c).astype(np.float32) + 0.5
    ref = jax_fused_bn_relu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                            jnp.asarray(mean), jnp.asarray(var), True)
    ours = bn_relu.fused_bn_relu(nchw(x), *map(torch.from_numpy, (scale, bias, mean, var)))
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=1e-5)


def test_bn_relu_bf16_computes_in_fp32():
    rng = np.random.RandomState(1)
    x = nchw(rng.randn(2, 4, 4, 8).astype(np.float32)).to(torch.bfloat16)
    a = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    y = bn_relu.fused_bn_relu_plain(x, a, b)
    assert y.dtype == torch.bfloat16
    ref = torch.relu(x.float() * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)).to(torch.bfloat16)
    assert torch.equal(y, ref)


def test_bn_relu_rejects_what_the_kernel_does_not_take():
    ones, zeros = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="channels_last"):
        bn_relu.fused_bn_relu(torch.randn(2, 4, 3, 5), ones, zeros, zeros, ones)
    with pytest.raises(TypeError):
        bn_relu.fused_bn_relu(torch.randn(2, 4, 3, 3, dtype=torch.float64).contiguous(
            memory_format=torch.channels_last), ones, zeros, zeros, ones)
    with pytest.raises(ValueError, match="float32"):
        bn_relu.fused_bn_relu(torch.randn(2, 3, 3, 3).contiguous(
            memory_format=torch.channels_last), ones, zeros, zeros, ones)


# ----- resize --------------------------------------------------------------

@pytest.mark.parametrize("axis,in_size,out_size,ac", [
    ("h", 16, 32, True), ("w", 24, 48, True), ("h", 16, 37, False), ("w", 24, 11, False)])
def test_resize_axis_plain_matches_pallas_interpret(axis, in_size, out_size, ac):
    rng = np.random.RandomState(0)
    shape = (2, in_size, 24, 8) if axis == "h" else (2, 16, in_size, 8)
    x = rng.rand(*shape).astype(np.float32)
    m = jnp.asarray(_interp_matrix(in_size, out_size, ac))
    if axis == "h":
        ref = jax_resize_mm.resize_h(jnp.asarray(x), m, out_size, True)
        ours = resize_mm.resize_h(nchw(x), out_size, ac)
    else:
        ref = jax_resize_mm.resize_w(jnp.asarray(x), m, out_size, True)
        ours = resize_mm.resize_w(nchw(x), out_size, ac)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 16, 24, 8), (32, 48)),     # 2x upsample
    ((1, 7, 5, 3), (19, 12)),       # non-square, non-integer ratios
    ((2, 32, 32, 1), (64, 64)),     # C = 1, the logits resize
    ((1, 20, 30, 4), (9, 13)),      # downsample
    ((1, 1, 6, 2), (4, 6)),         # H: 1 -> 4; W kept
])
@pytest.mark.parametrize("ac", [True, False])
def test_resize_bilinear_matches_jax(shape, out_hw, ac):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = jax_resize_bilinear(jnp.asarray(x), out_hw, align_corners=ac)
    ours = resize.resize_bilinear(nchw(x), out_hw, align_corners=ac)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(ours), np.asarray(ref), atol=1e-6)


def test_resize_matches_f_interpolate_and_keeps_equal_sizes():
    x = nchw(np.random.RandomState(3).randn(2, 9, 13, 5).astype(np.float32))
    for ac in (True, False):
        ref = torch.nn.functional.interpolate(x, size=(17, 6), mode="bilinear",
                                              align_corners=ac)
        torch.testing.assert_close(resize.resize_bilinear(x, (17, 6), ac), ref,
                                   atol=1e-5, rtol=0)
    assert resize.resize_bilinear(x, (9, 13)) is x


def test_resize_tables_follow_the_jax_coordinates():
    for in_size, out_size, ac in [(16, 32, True), (7, 19, False), (5, 1, True), (5, 1, False)]:
        i0, i1, lam = resize_mm.axis_table(in_size, out_size, ac)
        dense = np.zeros((out_size, in_size), np.float32)
        np.add.at(dense, (np.arange(out_size), i0), 1.0 - lam)
        np.add.at(dense, (np.arange(out_size), i1), lam)
        np.testing.assert_array_equal(dense, _interp_matrix(in_size, out_size, ac))


def test_resize_bf16_and_rejects_nchw_memory():
    x = nchw(np.random.RandomState(4).rand(1, 8, 8, 4).astype(np.float32)).to(torch.bfloat16)
    y = resize.resize_bilinear(x, (16, 16))
    assert y.dtype == torch.bfloat16
    ref = resize_mm.resize_plain(x.float(), (16, 16), True).to(torch.bfloat16)
    assert torch.equal(y, ref)
    with pytest.raises(ValueError, match="channels_last"):
        resize.resize_bilinear(torch.randn(1, 4, 8, 8), (16, 16))


def test_resize_nearest_and_upsample2x_match_jax():
    x = np.random.RandomState(5).randn(2, 6, 10, 3).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(resize.resize_nearest(nchw(x), (13, 4))),
        np.asarray(jax_resize_nearest(jnp.asarray(x), (13, 4))))
    np.testing.assert_allclose(
        nhwc(resize.upsample2x_bilinear_align_corners(nchw(x))),
        np.asarray(jax_resize_bilinear(jnp.asarray(x), (12, 20))), atol=1e-6)


def test_broadcast_latent_spatial():
    z = torch.randn(3, 5)
    out = resize.broadcast_latent_spatial(z, (4, 6))
    assert out.shape == (3, 5, 4, 6)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, z[:, :, None, None].expand(3, 5, 4, 6))


# ----- pools ---------------------------------------------------------------

@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, None, 0)])
def test_pools_match_jax(window, stride, padding):
    x = np.random.RandomState(6).randn(2, 11, 9, 4).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(pool.max_pool(nchw(x), window, stride, padding)),
        np.asarray(jax_max_pool(jnp.asarray(x), window, stride, padding)))
    np.testing.assert_allclose(pool.avg_pool_global(nchw(x)).numpy(),
                               np.asarray(jax_avg_pool(jnp.asarray(x))), atol=1e-6)


# ----- noise and reparameterization ----------------------------------------

@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expected):
    """The plain stream is Philox4x32-10 (Random123's known-answer vectors)."""
    words = reparam.philox4x32_10(*(torch.tensor([c]) for c in counter), *key)
    assert tuple(int(w) for w in words) == expected


def test_normal_plain_moments_and_determinism():
    z = reparam.normal_plain((8192, 64), seed=11)
    assert z.dtype == torch.float32 and z.shape == (8192, 64)
    assert abs(z.mean().item()) < 0.01 and abs(z.std().item() - 1.0) < 0.01
    assert torch.isfinite(z).all()
    small = reparam.normal((3, 32), 11, "cpu")
    assert torch.equal(small, reparam.normal((3, 32), 11, "cpu"))
    assert not torch.equal(small, reparam.normal((3, 32), 12, "cpu"))
    # element i depends on its index only: a prefix of a longer draw
    assert torch.equal(small.flatten(), z.flatten()[:96])


def test_reparameterize_plain_statistics():
    """The tests/test_pallas.py:80-102 case: z ~ N(mu, e^logvar * T^2)."""
    n = 4096
    mu = torch.tensor([1.0, -2.0]).expand(n, 2).contiguous()
    logvar = torch.tensor([0.0, float(np.log(4.0))]).expand(n, 2).contiguous()
    z = reparam.reparameterize(mu, logvar, seed=7, temperature=1.0)
    np.testing.assert_allclose(z.mean(0).numpy(), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(z.std(0).numpy(), [1.0, 2.0], rtol=0.1)
    z2 = reparam.reparameterize(mu, logvar, seed=7, temperature=2.0)
    np.testing.assert_allclose(z2.std(0).numpy(), [2.0, 4.0], rtol=0.1)
    assert torch.equal(z, reparam.reparameterize(mu, logvar, seed=7))
    assert not torch.equal(z, reparam.reparameterize(mu, logvar, seed=8))
    # exactly mu + eps * exp(0.5 logvar) * T on the plain stream, no clamp
    eps = reparam.normal_plain((n, 2), 7)
    torch.testing.assert_close(z2, mu + eps * torch.exp(0.5 * logvar) * 2.0)


def test_gaussian_like_generator_state():
    g = torch.Generator().manual_seed(0)
    a = gaussian_like(g, (4, 8), "cpu")
    b = gaussian_like(g, (4, 8), "cpu")
    assert not torch.equal(a, b)                       # successive calls differ
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(a, gaussian_like(g2, (4, 8), "cpu"))   # a fixed state repeats
    eps = torch.ones(4, 8)
    assert gaussian_like(None, (4, 8), "cpu", eps=eps) is not None
    with pytest.raises(ValueError):
        gaussian_like(None, (4, 8), "cpu")


@pytest.mark.parametrize("logvar_value", [None, 30.0])
def test_sample_latents_matches_jax_with_injected_eps(logvar_value):
    rng = np.random.RandomState(0)
    mu = rng.randn(4, 16).astype(np.float32)
    logvar = (rng.randn(4, 16).astype(np.float32) if logvar_value is None
              else np.full((4, 16), logvar_value, np.float32))
    key = jax.random.PRNGKey(3)
    ref = jax_sample_latents(jnp.asarray(mu), jnp.asarray(logvar), key,
                             temperature=2.0, num_samples=6)
    eps = np.array(jax.random.normal(key, (6, 4, 16)))
    ours = sample_latents(torch.from_numpy(mu), torch.from_numpy(logvar), None,
                          temperature=2.0, num_samples=6, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    if logvar_value is not None:   # the guard bounds wild logvar (test_pallas.py:126-127)
        assert (ours - torch.from_numpy(mu)).abs().max() < 10 * 2 * np.exp(LOGVAR_GUARD / 2)


def test_sample_latents_fused_path_clips_before_the_kernel():
    """The fused draw equals the plain reparameterization of the clipped
    logvar broadcast to [N*B, D], from the generator's next seed."""
    mu = torch.randn(2, 8)
    logvar = torch.full((2, 8), 30.0)
    zs = sample_latents(mu, logvar, torch.Generator().manual_seed(9), temperature=0.5,
                        num_samples=3)
    from vaeunet_tpu_torch.ops.sampling import seed_from_generator
    seed = seed_from_generator(torch.Generator().manual_seed(9))
    ref = reparam.reparameterize_plain(mu.repeat(3, 1), torch.full((6, 8), LOGVAR_GUARD),
                                       seed, 0.5)
    assert torch.equal(zs, ref.view(3, 2, 8))
