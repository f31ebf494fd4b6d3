"""The bf16 Ci <= 8 route of the conv3x3 + BN-moments kernel, on the CPU: a
numpy fp32 model of what a block of ``conv3x3_stats_ci8_kernel`` does --
its (4 + 2) x (64 + 2) halo with the zero padding, the implicit im2col K
order k = (ky * 3 + kx) * Ci + c padded with zero weights to a multiple of
16, each warp's 32 pixels and the mma.sync m16n8k16 fragments its lanes
gather, the masked ragged edge, the moments' lane butterfly, warp order
and scratch rows, and the reduce kernel's fixed order -- against the plain
conv and the JAX ``conv3x3_bn_stats`` in interpret mode; which C entry each
(Ci, Co, dtype) takes; the launch's arguments (no padded copy of x); and
the constants against the CUDA source.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``).  Inputs come from numpy seeds and are
bf16 values held in fp32, as the kernel reads them."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaeunet_tpu.ops.pallas.conv_bn_stats import conv3x3_bn_stats as jax_conv3x3_bn_stats

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats as cm

TH, TW, BN = cm.SMALL_TILE_H, cm.SMALL_TILE_W, 64
WARPS = 8
SOURCE = Path(cm.__file__).resolve().parents[2] / "csrc" / "conv_bn_stats.cu"


def _case(shape, co, seed=0):
    """bf16-representable x (NCHW, channels_last) and OIHW weights, fp32."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16).float()
    w = torch.from_numpy((rng.randn(co, shape[1], 3, 3) / (3 * shape[1] ** 0.5))
                         .astype(np.float32)).to(torch.bfloat16).float()
    return x.contiguous(memory_format=torch.channels_last), w


def k_map(ci: int):
    """-> per K index of the padded K: (valid, halo row offset ky, halo
    column offset kx, channel c), as the kernel derives them."""
    kp = cm._round_up(9 * ci, cm.SMALL_K_ALIGN)
    k = np.arange(kp)
    tap, c = k // ci, k % ci
    return k < 9 * ci, tap // 3, tap % 3, c


def lane_fragments():
    """-> for lane l (g = l // 4, tg = l % 4): the (row, K) of its A
    elements in register order, the (K, column) of its B elements, the
    (row, column) of its D elements (mma.sync m16n8k16)."""
    lanes = np.arange(32)
    g, tg = lanes // 4, lanes % 4
    a = np.stack([np.stack([g, 2 * tg]), np.stack([g, 2 * tg + 1]),            # reg 0
                  np.stack([g + 8, 2 * tg]), np.stack([g + 8, 2 * tg + 1]),    # reg 1
                  np.stack([g, 8 + 2 * tg]), np.stack([g, 9 + 2 * tg]),        # reg 2
                  np.stack([g + 8, 8 + 2 * tg]), np.stack([g + 8, 9 + 2 * tg])], 1)  # reg 3
    b = np.stack([np.stack([2 * tg, g]), np.stack([2 * tg + 1, g]),
                  np.stack([8 + 2 * tg, g]), np.stack([9 + 2 * tg, g])], 1)
    d = np.stack([np.stack([g, 2 * tg]), np.stack([g, 2 * tg + 1]),
                  np.stack([g + 8, 2 * tg]), np.stack([g + 8, 2 * tg + 1])], 1)
    return a.transpose(2, 1, 0), b.transpose(2, 1, 0), d.transpose(2, 1, 0)   # [32, n, 2]


def kernel_model(x: torch.Tensor, weight: torch.Tensor):
    """The Ci <= 8 kernel block by block in numpy fp32: -> y, s, q, the
    scratch rows."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    wk = cm.weights_small_ci(weight).numpy()                      # [Co, Kp]
    kp = wk.shape[1]
    valid, ky, kx, cc = k_map(ci)
    xn = x.permute(0, 2, 3, 1).numpy()                            # NHWC
    afr, bfr, dfr = lane_fragments()
    y = np.full((b, h, w, co), np.nan, np.float32)
    rows_s, rows_q = [], []
    for bi in range(b):
        for h0 in range(0, h, TH):
            for w0 in range(0, w, TW):
                row_s = np.zeros(co, np.float32)
                row_q = np.zeros(co, np.float32)
                # the halo: rows h0 - 1 .. h0 + TH, columns w0 - 1 .. w0 + TW
                halo = np.zeros((TH + 2, TW + 2, ci), np.float32)
                r0, r1 = max(h0 - 1, 0), min(h0 + TH + 1, h)
                c0, c1 = max(w0 - 1, 0), min(w0 + TW + 1, w)
                halo[r0 - h0 + 1:r1 - h0 + 1, c0 - w0 + 1:c1 - w0 + 1] = xn[bi, r0:r1, c0:c1]
                for co0 in range(0, co, BN):
                    ws = np.zeros((BN, kp), np.float32)            # rows past Co are zero
                    ws[:min(BN, co - co0)] = wk[co0:co0 + BN]
                    red_s = np.zeros((WARPS, BN), np.float32)
                    red_q = np.zeros((WARPS, BN), np.float32)
                    for warp in range(WARPS):
                        row, colw = warp // 2, (warp % 2) * 32
                        acc = np.zeros((2, 8, 32, 4), np.float32)  # [m][n tile][lane][reg]
                        for m in range(2):
                            for s in range(kp // 16):
                                # A: each lane gathers its 8 elements from the halo
                                a_tile = np.zeros((16, 16), np.float32)
                                for lane in range(32):
                                    for pr, kk in afr[lane]:
                                        k = s * 16 + kk
                                        col = colw + 16 * m + pr
                                        a_tile[pr, kk] = (halo[row + ky[k], col + kx[k], cc[k]]
                                                          if valid[k] else 0.0)
                                for j in range(8):
                                    b_tile = np.zeros((16, 8), np.float32)
                                    for lane in range(32):
                                        for kk, n in bfr[lane]:
                                            b_tile[kk, n] = ws[8 * j + n, s * 16 + kk]
                                    prod = a_tile @ b_tile
                                    for lane in range(32):
                                        for e, (pr, n) in enumerate(dfr[lane]):
                                            acc[m, j, lane, e] += prod[pr, n]
                        # the epilogue: y and the lanes' moments over valid pixels
                        ls = np.zeros((32, 8, 2), np.float32)
                        lq = np.zeros((32, 8, 2), np.float32)
                        hh = h0 + row
                        for m in range(2):
                            for hr in range(2):
                                for lane in range(32):
                                    col = w0 + colw + 16 * m + lane // 4 + 8 * hr
                                    if hh < h and col < w:
                                        v = acc[m, :, lane, 2 * hr:2 * hr + 2]     # [8, 2]
                                        ls[lane] += v
                                        lq[lane] += v * v
                                        for j in range(8):
                                            for e in range(2):
                                                o = co0 + 8 * j + 2 * (lane % 4) + e
                                                if o < co:
                                                    y[bi, hh, col, o] = v[j, e]
                        for msk in (4, 8, 16):                     # the butterfly
                            ls = ls + ls[np.arange(32) ^ msk]
                            lq = lq + lq[np.arange(32) ^ msk]
                        for lane in range(4):
                            for j in range(8):
                                for e in range(2):
                                    red_s[warp, 8 * j + 2 * lane + e] = ls[lane, j, e]
                                    red_q[warp, 8 * j + 2 * lane + e] = lq[lane, j, e]
                    tot_s = np.zeros(BN, np.float32)
                    tot_q = np.zeros(BN, np.float32)
                    for warp in range(WARPS):                      # the warps in order
                        tot_s += red_s[warp]
                        tot_q += red_q[warp]
                    n_co = min(BN, co - co0)
                    row_s[co0:co0 + n_co] = tot_s[:n_co]
                    row_q[co0:co0 + n_co] = tot_q[:n_co]
                rows_s.append(row_s)
                rows_q.append(row_q)
    return (torch.from_numpy(y).permute(0, 3, 1, 2), torch.from_numpy(reduce_model(rows_s)),
            torch.from_numpy(reduce_model(rows_q)), len(rows_s))


def reduce_model(rows):
    """reduce_partials_kernel: lane l sums rows l, l + 32, ... in turn,
    then the 32 lane sums are added in lane order."""
    part = np.stack(rows)
    lanes = np.zeros((32, part.shape[1]), np.float32)
    for r in range(part.shape[0]):
        lanes[r % 32] += part[r]
    out = np.zeros(part.shape[1], np.float32)
    for lane in range(32):
        out += lanes[lane]
    return out


def test_fragments_cover_each_tile_once():
    afr, bfr, dfr = lane_fragments()
    assert sorted(map(tuple, afr.reshape(-1, 2))) == [(r, k) for r in range(16) for k in range(16)]
    assert sorted(map(tuple, bfr.reshape(-1, 2))) == [(k, n) for k in range(16) for n in range(8)]
    assert sorted(map(tuple, dfr.reshape(-1, 2))) == [(r, n) for r in range(16) for n in range(8)]


@pytest.mark.parametrize("ci", [1, 3, 4, 8])
def test_k_order_and_padding(ci):
    """K = 9 Ci in tap-major order (tap = ky * 3 + kx), each tap's channels
    together, padded to a multiple of 16 with zero weights; the weights'
    column k is the OIHW weight at (ky, kx, c)."""
    valid, ky, kx, cc = k_map(ci)
    assert len(valid) % 16 == 0 and valid.sum() == 9 * ci and len(valid) - 9 * ci < 16
    assert [(a, b, c) for a, b, c, v in zip(ky, kx, cc, valid) if v] == \
        [(a, b, c) for a in range(3) for b in range(3) for c in range(ci)]
    _, w = _case((1, ci, 4, 4), 16, seed=ci)
    wk = cm.weights_small_ci(w)
    assert wk.shape == (16, len(valid)) and wk.is_contiguous()
    for k in np.flatnonzero(valid):
        assert torch.equal(wk[:, k], w[:, cc[k], ky[k], kx[k]])
    assert not wk[:, ~torch.from_numpy(valid)].any()


@pytest.mark.parametrize("shape,co", [((2, 1, 6, 70), 64),      # ragged H and W, two column tiles
                                      ((1, 3, 5, 66), 72),      # two channel blocks (64 + 8)
                                      ((1, 8, 4, 64), 16)])     # whole tiles; Co under a block
def test_kernel_model_matches_plain(shape, co):
    x, w = _case(shape, co)
    y, s, q, rows = kernel_model(x, w)
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    assert not torch.isnan(y).any()                              # every valid pixel written
    torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(q, rq, atol=1e-4, rtol=1e-5)
    assert rows == cm.scratch_rows(shape[0], shape[2], shape[3], TH, TW)


@pytest.mark.parametrize("ci", [1, 3, 8])
def test_kernel_model_matches_pallas_interpret(ci):
    """The route's model against the JAX kernel in interpret mode on a
    ragged shape (H off both kernels' row tiles, W off the 64-column tile)."""
    x, w = _case((2, ci, 7, 67), 16, seed=10 + ci)
    y, s, q, _ = kernel_model(x, w)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    kj = jnp.asarray(w.permute(2, 3, 1, 0).numpy())              # HWIO
    ry, rs, rq = jax_conv3x3_bn_stats(xj, kj, jnp.float32, 8, True)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(ry), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ci,co,dtype,entry", [
    (3, 64, torch.bfloat16, cm.SMALL_CI_ENTRY),     # the plain UNet's first conv
    (1, 8, torch.bfloat16, cm.SMALL_CI_ENTRY),
    (8, 72, torch.bfloat16, cm.SMALL_CI_ENTRY),
    (5, 7, torch.bfloat16, cm.WGMMA_ENTRY),         # Co off a multiple of 8
    (9, 64, torch.bfloat16, cm.WGMMA_ENTRY),
    (64, 64, torch.bfloat16, cm.WGMMA_ENTRY),
    (3, 64, torch.float32, cm.F32_ENTRY),
    (224, 64, torch.float32, cm.F32_ENTRY)])
def test_route(ci, co, dtype, entry):
    assert cm.route(ci, co, dtype) == entry


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def entry(*args):
            self.calls.append((fn, args))
            return 0
        return entry


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_ext, "_FNS", {})
    monkeypatch.setattr(_ext, "library", lambda name: lib)
    monkeypatch.setattr(_ext, "_current_device", lambda: 0)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 77)
    return lib


def test_ci3_bf16_launch_takes_x_as_it_is(fake, monkeypatch):
    """The UNet's Ci = 3 bf16 conv hands the Ci <= 8 entry x itself (no
    pad_channels copy), the [Co, 32] weights, y, the scratch of its 4 x 64
    tiles, s, q, B, H, W, Ci, Co and the rows; it counts on its own
    counter, not on conv_bn_stats."""
    def no_pad(*a):
        raise AssertionError("pad_channels called on the Ci <= 8 route")
    monkeypatch.setattr(cm, "pad_channels", no_pad)
    x, w = _case((2, 3, 9, 70), 64)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    before = _ext.launch_counts()
    y, s, q = cm._forward_cuda(x, w)
    after = _ext.launch_counts()
    assert after["conv_bn_stats_ci8"] == before["conv_bn_stats_ci8"] + 1
    assert after["conv_bn_stats"] == before["conv_bn_stats"]
    (fn, args), = fake.calls
    tiles = cm.scratch_rows(2, 9, 70, TH, TW)
    assert fn == cm.SMALL_CI_ENTRY and tiles == 2 * 3 * 2
    assert len(args) == len(_ext.SIGNATURES["conv_bn_stats"][fn])
    assert args[0] == x.data_ptr() and args[2] == y.data_ptr()
    assert args[4] - args[3] == 4 * tiles * 64
    assert (args[5], args[6]) == (s.data_ptr(), q.data_ptr())
    assert args[7:] == (2, 9, 70, 3, 64, tiles, 77)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)


def test_wgmma_route_still_pads(fake, monkeypatch):
    calls = []
    real = cm.pad_channels
    monkeypatch.setattr(cm, "pad_channels", lambda x, c: calls.append(c) or real(x, c))
    x, w = _case((1, 5, 6, 20), 7)
    cm._forward_cuda(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert calls == [8] and fake.calls[0][0] == cm.WGMMA_ENTRY


def test_constants_match_the_source():
    src = SOURCE.read_text()
    for name, value in (("kSTH", TH), ("kSTW", TW), ("kSBN", BN), ("kSThreads", 32 * WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "(kK + 15) / 16 * 16" in src and cm.SMALL_K_ALIGN == 16
    assert re.search(r"Ci < 1 \|\| Ci > 8 \|\| Co < 8 \|\| Co % 8 != 0", src)
    assert cm.SMALL_CI_MAX == 8 and cm.SMALL_CO_ALIGN == 8
