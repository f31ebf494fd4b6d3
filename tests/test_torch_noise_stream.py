"""The noise stream of ``csrc/reparam.cu`` through its plain version, on the
CPU: the layout (element 4k + j from Philox4x32-10 at counter k, lanes
r cos t and r sin t of the word pairs (x, y) and (z, w)) against an
independent numpy Philox and Box-Muller in float64; the prefix property at
ragged lengths; each lane's moments, a KS test of 2^20 draws against
N(0, 1) and the lag-1 correlation; the fused draw exactly mu + eps x std;
and the stream against the JAX package's ``gaussian_like`` on the CPU
(``jax.random.normal``: ``normal_pallas`` has no CPU interpret rule) at the
distribution level.  The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from scipy import stats

import jax

from vaeunet_tpu.ops.sampling import gaussian_like as jax_gaussian_like

from vaeunet_tpu_torch.ops.pallas import reparam

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
N_DRAWS = 1 << 20


def philox_numpy(k: np.ndarray, seed: int) -> np.ndarray:
    """Philox4x32-10 at counters (k, 0) under key `seed`, in numpy uint64:
    -> words [len(k), 4]."""
    c = [k & MASK, k >> 32, np.zeros_like(k), np.zeros_like(k)]
    k0, k1 = seed & MASK, seed >> 32
    for _ in range(10):
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & MASK, (p0 >> 32) ^ c[3] ^ k1, p0 & MASK]
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return np.stack(c, 1)


def normals_numpy(n: int, seed: int) -> np.ndarray:
    """The stream's first `n` elements in float64."""
    words = philox_numpy(np.arange(-(-n // 4), dtype=np.uint64), seed)
    out = []
    for b1, b2 in ((words[:, 0], words[:, 1]), (words[:, 2], words[:, 3])):
        u1 = (b1 >> 8).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25
        u2 = (b2 >> 8).astype(np.float64) * 2.0 ** -24
        r, t = np.sqrt(-2.0 * np.log(u1)), 2 * np.pi * u2
        out += [r * np.cos(t), r * np.sin(t)]
    return np.stack(out, 1).reshape(-1)[:n]


@pytest.fixture(scope="module")
def draws():
    return reparam.normal_plain((N_DRAWS,), 11).numpy().astype(np.float64)


@pytest.mark.parametrize("seed", [0, 11, (1 << 64) - 1, 0x243F6A8885A308D3])
def test_layout_is_four_lanes_of_one_philox_call(seed):
    """Element 4k + j: j = 0, 1 the cos and sin halves of words (x, y) of
    counter k, j = 2, 3 those of (z, w); within 1e-5 of float64 (the fp32
    rounding of the uniforms' products, log, sqrt, sin and cos)."""
    n = 4 * 257 + 3
    ours = reparam.normal_plain((n,), seed).numpy()
    np.testing.assert_allclose(ours, normals_numpy(n, seed), atol=1e-5, rtol=0)
    words = reparam.philox_words(8, seed, "cpu")
    np.testing.assert_array_equal(np.stack([w.numpy() for w in words], 1),
                                  philox_numpy(np.arange(8, dtype=np.uint64), seed))


@pytest.mark.parametrize("n", [1, 3, 5, 4 * 1000 + 1])
def test_a_draw_is_the_prefix_of_a_longer_one(n):
    longer = reparam.normal_plain((4 * 1024 + 7,), 5)
    assert torch.equal(reparam.normal_plain((n,), 5), longer[:n])
    assert torch.equal(reparam.normal((n,), 5, "cpu"), longer[:n])


@pytest.mark.parametrize("lane", [0, 1, 2, 3])
def test_each_lane_is_standard_normal(draws, lane):
    """Each of the four lanes alone: mean and variance within 5 standard
    errors of N(0, 1)'s (2^18 draws), and the KS statistic under its 0.1 %
    critical value."""
    z = draws[lane::4]
    n = len(z)
    assert abs(z.mean()) < 5 / np.sqrt(n)
    assert abs(z.var() - 1) < 5 * np.sqrt(2 / n)
    assert stats.kstest(z, "norm").statistic < 1.95 / np.sqrt(n)


def test_the_stream_is_standard_normal_and_uncorrelated(draws):
    """2^20 draws: the KS statistic against N(0, 1) under its 0.1 %
    critical value; the lag-1 correlation |r| < 5e-3 (5 standard errors is
    4.9e-3); that of the cos and sin halves of one pair, and of lanes 1 and
    2 (two word pairs of one call), |r| < 1e-2 (5 standard errors at 2^18
    pairs)."""
    n = len(draws)
    assert stats.kstest(draws, "norm").statistic < 1.95 / np.sqrt(n)
    assert abs(np.corrcoef(draws[:-1], draws[1:])[0, 1]) < 5e-3
    assert abs(np.corrcoef(draws[0::4], draws[1::4])[0, 1]) < 1e-2
    assert abs(np.corrcoef(draws[1::4], draws[2::4])[0, 1]) < 1e-2


@pytest.mark.parametrize("shape,temperature", [((10, 32), 1.0), ((3, 5), 0.5)])
def test_reparameterize_is_mu_plus_the_noise_times_std(shape, temperature):
    rng = np.random.RandomState(3)
    mu = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    logvar = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    z = reparam.reparameterize(mu, logvar, 9, temperature)
    eps = reparam.normal(shape, 9, "cpu")
    assert torch.equal(z, mu + eps * (torch.exp(0.5 * logvar) * temperature))


def test_the_stream_matches_jax_gaussian_like_in_distribution(draws):
    """The JAX package's noise on the CPU (``jax.random.normal``) and the
    port's stream: the two-sample KS statistic under its 0.1 % critical
    value, and the first four moments within 5 standard errors of each
    other."""
    ref = np.asarray(jax_gaussian_like(jax.random.PRNGKey(7), (256, 1024)),
                     np.float64).reshape(-1)
    ours = draws[:len(ref)]
    n = len(ref)
    assert stats.ks_2samp(ours, ref).statistic < 1.95 * np.sqrt(2 / n)
    assert abs(ours.mean() - ref.mean()) < 5 * np.sqrt(2 / n)
    assert abs(ours.var() - ref.var()) < 5 * np.sqrt(4 / n)
    assert abs(stats.skew(ours) - stats.skew(ref)) < 5 * np.sqrt(12 / n)
    assert abs(stats.kurtosis(ours) - stats.kurtosis(ref)) < 5 * np.sqrt(48 / n)
