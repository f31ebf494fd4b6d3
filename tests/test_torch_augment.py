"""The port's on-device augmentation against ``vaeunet_tpu/data/augment.py``
on the CPU.  Each JAX transform runs with a key; the test draws the
transform's parameters from the same key splits with ``jax.random`` and
hands them to the port's ``apply_*``.  The JAX transforms run eagerly
(vmapped, not jitted): under ``jit`` XLA fuses the coordinate arithmetic
and moves it by an ulp.

Tolerances:
- flips, rot90 and every mask: exact;
- gamma, colour, noise (the same eps), blur, grid distortion: 1e-6 (the
  fp32 sum order of a mean or a 5x5 conv, ``pow`` and ``exp`` by an ulp);
- affine: 2^-7 over at most 0.1 % of the values, exact elsewhere (measured:
  exact everywhere).  The warp's weights, image and intermediate are bf16
  and its products exact in fp32, so each output is one rounding of the
  same two terms; but the coordinates go through cos and sin, which the
  port rounds from fp64 while XLA's fp32 sin is off by an ulp for ~2 % of
  angles.  An ulp of a coordinate can move one bf16 weight by one bf16 ulp
  (2^-8 below 1) and the intermediate's rounding by one (2^-8), so a pixel
  whose neighbours differ by at most 1 moves by at most 2 x 2^-8;
- CLAHE: 1e-5 (the histograms are exact counts; the clip sum, the CDF's
  cumsum and the 9-term blend differ in fp32 order), except where the
  bf16 rounding of a LUT entry flips: one bf16 ulp (<= 2^-8) of a LUT
  value moves the new luma by at most 2^-8 and the output by at most
  2^-8 * image / luma; allowed at <= 0.1 % of the values (measured: none);
- the whole policy (``augment_sample`` jitted, for time): masks exact, images
  2^-7, which allows one such bf16 step where an earlier transform's 1e-6
  difference flips the affine warp's rounding.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vaeunet_tpu.data.augment as JA

from vaeunet_tpu_torch.data import augment as TA

B, H, W = 6, 40, 48
U = jax.random.uniform
BERN = jax.random.bernoulli


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    mask = (rng.rand(B, H, W, 1) > 0.7).astype(np.float32)
    return img, mask


def keys(seed: int, n: int = B):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).float()


def jax_params(ks, p, draw):
    """vmap of the transform's own draws over the per-sample keys."""
    return [t(x) for x in jax.vmap(lambda k: draw(k, p))(ks)]


def draw_flips(k, _):
    k1, k2, k3 = jax.random.split(k, 3)
    rot = jnp.where(BERN(k3), jax.random.randint(jax.random.fold_in(k3, 1), (), 0, 4), 0)
    return BERN(k1), BERN(k2), rot


def draw_contrast(k, p):
    k0, k1, k2, k3 = jax.random.split(k, 4)
    return BERN(k0, p), BERN(k1), U(k2, (), minval=1.5, maxval=4.0), U(k3, (), minval=0.8,
                                                                      maxval=1.2)


def draw_color(k, p):
    ks = jax.random.split(k, 7)
    return (BERN(ks[0], p), BERN(ks[1]), U(ks[2], (), minval=-0.1, maxval=0.1),
            U(ks[3], (), minval=-0.1, maxval=0.1)) + tuple(
        U(ks[i], (), minval=0.9, maxval=1.1) for i in (4, 5, 6))


def draw_affine(k, p):
    ks = jax.random.split(k, 5)
    return (BERN(ks[0], p), U(ks[1], (), minval=0.9, maxval=1.1),
            U(ks[2], (), minval=-0.0625, maxval=0.0625),
            U(ks[3], (), minval=-0.0625, maxval=0.0625), U(ks[4], (), minval=-15.0, maxval=15.0))


def draw_noise(k, p, shape=(H, W, 3)):
    k0, k1, k2 = jax.random.split(k, 3)
    return BERN(k0, p), U(k1, (), minval=10.0, maxval=50.0), jax.random.normal(k2, shape)


def draw_blur(k, p):
    ks = jax.random.split(k, 4)
    return BERN(ks[0], p), BERN(ks[1]), BERN(ks[2]), jax.random.randint(ks[3], (), 0, 4)


def draw_grid(k, p):
    k0, kx, ky = jax.random.split(k, 3)
    return (BERN(k0, p), U(kx, (6,), minval=-0.1, maxval=0.1),
            U(ky, (6,), minval=-0.1, maxval=0.1))


def run_jax(fn, ks, *arrays, **kw):
    out = jax.vmap(lambda k, *a: fn(k, *a, **kw))(ks, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else np.asarray(out)


def test_flips_and_rot90_are_exact():
    rng = np.random.RandomState(1)
    img = rng.rand(32, 24, 24, 3).astype(np.float32)
    mask = rng.rand(32, 24, 24, 2).astype(np.float32)
    ks = keys(3, 32)
    ji, jm = run_jax(JA._maybe_flips, ks, img, mask)
    h, v, k = jax_params(ks, None, draw_flips)
    assert set(k.tolist()) == {0.0, 1.0, 2.0, 3.0} and h.any() and v.any()
    ti, tm = TA.apply_flips(t(img), t(mask), h, v, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tm.numpy(), jm)
    # non-square: flips only, as in JAX
    ks = keys(4, B)
    img, mask = rng.rand(B, 20, 28, 3).astype(np.float32), rng.rand(B, 20, 28, 1).astype(np.float32)
    ji, jm = run_jax(JA._maybe_flips, ks, img, mask)
    h, v, k = jax_params(ks, None, draw_flips)
    ti, tm = TA.apply_flips(t(img), t(mask), h, v, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tm.numpy(), jm)


@pytest.mark.parametrize("p", [1.0, None], ids=["applied", "policy-p"])
def test_affine(data, p):
    img, mask = data
    ks = keys(5)
    kw = {} if p is None else {"p": p}
    ji, jm = run_jax(JA._affine, ks, img, mask, **kw)
    params = jax_params(ks, 0.3 if p is None else p, draw_affine)
    ti, tm = TA.apply_affine(t(img), t(mask), *params)
    np.testing.assert_array_equal(tm.numpy(), jm)
    diff = np.abs(ti.numpy() - ji)
    assert diff.max() <= 2.0 ** -7 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    if p is None:
        # not applied: the identity warp still rounds the image to bf16
        off = (params[0] == 0).numpy()
        assert off.any()
        np.testing.assert_array_equal(
            ti.numpy()[off], t(img)[off].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("p", [1.0, None], ids=["applied", "policy-p"])
def test_grid_distortion(data, p):
    img, mask = data
    ks = keys(6)
    kw = {} if p is None else {"p": p}
    ji, jm = run_jax(JA._grid_distortion, ks, img, mask, **kw)
    ti, tm = TA.apply_grid(t(img), t(mask), *jax_params(ks, 0.2 if p is None else p, draw_grid))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(ti.numpy(), ji, atol=1e-6, rtol=0)


@pytest.mark.parametrize("p", [1.0, None], ids=["applied", "policy-p"])
@pytest.mark.parametrize("name", ["color", "noise", "blur", "contrast"])
def test_photometric(data, name, p):
    img, _ = data
    ks = keys({"color": 7, "noise": 8, "blur": 9, "contrast": 10}[name])
    kw = {} if p is None else {"p": p}
    fn, draw, apply, p_default = {
        "color": (JA._color_group, draw_color, TA.apply_color, 0.3),
        "noise": (JA._gauss_noise, draw_noise, TA.apply_noise, 0.2),
        "blur": (JA._blur_group, draw_blur, TA.apply_blur, 0.2),
        "contrast": (JA._contrast_group, draw_contrast, TA.apply_contrast, 0.5)}[name]
    ji = run_jax(fn, ks, img, **kw)
    ti = apply(t(img), *jax_params(ks, p_default if p is None else p, draw)).numpy()
    if name == "contrast":
        assert_clahe_close(ti, ji, img)
    else:
        np.testing.assert_allclose(ti, ji, atol=1e-6, rtol=0)


def assert_clahe_close(ours, theirs, img):
    diff = np.abs(ours - theirs)
    lum = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    flip_room = 2.0 ** -8 * img / np.maximum(lum, 1e-6)[..., None]
    assert (diff <= 1e-5 + flip_room).all()
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).mean()


def test_clahe_at_fixed_clip_limits(data):
    img, _ = data
    clip = np.linspace(1.5, 4.0, B).astype(np.float32)
    theirs = np.asarray(jax.vmap(JA._clahe)(jnp.asarray(img), jnp.asarray(clip)))
    assert_clahe_close(TA.clahe(t(img), t(clip)).numpy(), theirs, img)
    # a tile grid that divides the image: no edge padding
    sq = img[:, :32, :32]
    theirs = np.asarray(jax.vmap(JA._clahe)(jnp.asarray(sq), jnp.asarray(clip)))
    assert_clahe_close(TA.clahe(t(sq), t(clip)).numpy(), theirs, sq)


def jax_policy_params(k, hw):
    """The parameters ``augment_sample`` draws from `k`, as the port's table."""
    k0, k1, k2, k3, k4, k5, k6 = jax.random.split(k, 7)
    h, v, rot = draw_flips(k0, None)
    c = draw_contrast(k1, 0.5)
    col = draw_color(k2, 0.3)
    aff = draw_affine(k3, 0.3)
    nz = draw_noise(k4, 0.2, (*hw, 3))
    bl = draw_blur(k5, 0.2)
    gr = draw_grid(k6, 0.2)
    names = ("do_h", "do_v", "rot_k", "contrast", "use_clahe", "clip", "gamma", "color",
             "use_bc", "alpha", "beta", "jit_b", "jit_c", "jit_s", "affine", "scale", "tx",
             "ty", "theta", "noise", "var", "blur", "use_gauss", "use5", "direction", "grid",
             "grid_x", "grid_y")
    vals = (h, v, rot, *c, *col, *aff, *nz[:2], *bl, *gr)
    return {n: x for n, x in zip(names, vals)}, nz[2]


def test_whole_policy_matches_augment_sample():
    rng = np.random.RandomState(2)
    n, hw = 12, (32, 32)
    img = rng.rand(n, *hw, 3).astype(np.float32)
    mask = (rng.rand(n, *hw, 1) > 0.8).astype(np.float32)
    ks = keys(11, n)
    # jitted: eager, the policy's few hundred ops dispatch one by one
    ji, jm = [np.asarray(o) for o in jax.jit(jax.vmap(JA.augment_sample))(ks, img, mask)]
    raw, eps = jax.vmap(lambda k: jax_policy_params(k, hw))(ks)
    params = TA.params_to({k: t(v) for k, v in raw.items()}, "cpu")
    ti, tm = TA.apply_policy(params, t(img), t(mask), t(eps))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(ti.numpy(), ji, atol=2.0 ** -7, rtol=0)


def test_params_round_trip_and_shapes():
    p = TA.draw_params(torch.Generator().manual_seed(0), 5)
    assert set(p) == {n for n, _ in TA.COLUMNS}
    back = TA.params_to(p, "cpu")
    for n, w in TA.COLUMNS:
        assert back[n].shape == ((5,) if w == 1 else (5, w))
        assert torch.equal(back[n], p[n].reshape(back[n].shape))
    assert TA.WIDTH == 38


def test_policy_frequencies_are_binomial():
    n = 40000
    p = TA.draw_params(torch.Generator().manual_seed(1), n)
    flags = {"do_h": 0.5, "do_v": 0.5, "contrast": 0.5, "use_clahe": 0.5, "color": 0.3,
             "use_bc": 0.5, "affine": 0.3, "noise": 0.2, "blur": 0.2, "use_gauss": 0.5,
             "use5": 0.5, "grid": 0.2}
    for name, q in flags.items():
        freq = p[name].mean().item()
        assert abs(freq - q) <= 5 * math.sqrt(q * (1 - q) / n), (name, freq, q)
    rot = p["rot_k"]
    for k, q in ((0, 0.5 + 0.125), (1, 0.125), (2, 0.125), (3, 0.125)):
        freq = (rot == k).float().mean().item()
        assert abs(freq - q) <= 5 * math.sqrt(q * (1 - q) / n), ("rot", k, freq)
    for k in range(4):
        freq = (p["direction"] == k).float().mean().item()
        assert abs(freq - 0.25) <= 5 * math.sqrt(0.25 * 0.75 / n)
    for name, lo, hi in (("clip", 1.5, 4.0), ("gamma", 0.8, 1.2), ("scale", 0.9, 1.1),
                         ("theta", -15.0, 15.0), ("var", 10.0, 50.0), ("grid_x", -0.1, 0.1)):
        v = p[name]
        assert lo <= v.min().item() and v.max().item() <= hi
        assert abs(v.mean().item() - (lo + hi) / 2) <= 5 * (hi - lo) / math.sqrt(12 * v.numel())


def test_fixed_generator_repeats_the_batch():
    rng = np.random.RandomState(3)
    img = t(rng.rand(4, 24, 24, 3))
    mask = t(rng.rand(4, 24, 24, 1) > 0.5)
    a = TA.augment_batch(torch.Generator().manual_seed(5), img, mask)
    b = TA.augment_batch(torch.Generator().manual_seed(5), img, mask)
    c = TA.augment_batch(torch.Generator().manual_seed(6), img, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == img.shape and a[1].shape == mask.shape
    assert bool(((a[0] >= 0) & (a[0] <= 1)).all()) and set(a[1].unique().tolist()) <= {0.0, 1.0}
