"""What surrounds the fp32 conv3x3 + BN-moments kernel, on the CPU: a numpy
fp32 model of what a block of ``conv3x3_stats_f32_kernel`` does -- its
staged patch with the zero padding, its chunk order, the thread -> (pixels,
channels) map, the tile's moment row -- against the plain conv; the
tap-major weights; the shared-memory formula and the constants against the
CUDA source; and the C entry's argument list with a fake library.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).  Inputs
come from numpy seeds."""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats as cm

TH, TW = cm.TILE_H, cm.TILE_W
BN = cm.F32_BLOCK_CO
THREADS = 2 * BN


def _case(shape, co, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy((rng.randn(co, shape[1], 3, 3) * 0.2).astype(np.float32))
    return x, w


def thread_map():
    """-> tile row [128], first tile column [128], channels [128, 8] of a
    block's threads, as the kernel derives them from threadIdx.x."""
    t = np.arange(THREADS)
    cg, pg = t % (BN // 8), t // (BN // 8)
    pr = (pg & 3) + ((pg >> 3) << 2)
    pc0 = ((pg >> 2) & 1) * 8
    chan = np.concatenate([cg[:, None] * 4 + np.arange(4), BN // 2 + cg[:, None] * 4
                           + np.arange(4)], axis=1)
    return pr, pc0, chan, pg


def kernel_model(x: torch.Tensor, weight: torch.Tensor, chunk: int = cm.F32_CHUNK):
    """The fp32 kernel block by block in numpy fp32.  -> y, s, q, scratch rows."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    pads = (cm._round_up(ci, cm.F32_CI_ALIGN), cm._round_up(co, cm.F32_CO_ALIGN))
    wk = cm.weights_tap_major(weight, *pads).numpy()              # [9, ci_pad, co_pad]
    xn = x.permute(0, 2, 3, 1).numpy()                             # NHWC
    pr, pc0, chan, pg = thread_map()
    cols = pc0[:, None] + np.arange(8)                             # [128, 8] tile columns
    y = np.full((b, h, w, co), np.nan, np.float32)
    part_s, part_q = [], []
    for bi in range(b):
        for h0 in range(0, h, TH):
            for w0 in range(0, w, TW):
                row_s = np.zeros(co, np.float32)
                row_q = np.zeros(co, np.float32)
                for co0 in range(0, co, BN):
                    acc = np.zeros((THREADS, 8, 8), np.float32)
                    for ci0 in range(0, ci, chunk):
                        # one stage: the patch, zero outside x and past Ci; the weights
                        xs = np.zeros((TH + 2, TW + 2, chunk), np.float32)
                        r0, r1 = max(h0 - 1, 0), min(h0 + TH + 1, h)
                        c0, c1 = max(w0 - 1, 0), min(w0 + TW + 1, w)
                        n = min(chunk, ci - ci0)
                        xs[r0 - h0 + 1:r1 - h0 + 1, c0 - w0 + 1:c1 - w0 + 1, :n] = \
                            xn[bi, r0:r1, c0:c1, ci0:ci0 + n]
                        ws = wk[:, ci0:ci0 + chunk, co0:co0 + BN]
                        assert ws.shape == (9, chunk, BN)          # the padding makes it whole
                        for c4 in range(0, chunk, 4):
                            for ky in range(3):
                                for cc in range(4):
                                    for kx in range(3):
                                        a = xs[pr[:, None] + ky, cols + kx, c4 + cc]   # [128, 8]
                                        wv = ws[ky * 3 + kx, c4 + cc][chan]            # [128, 8]
                                        acc += a[:, :, None] * wv[:, None, :]
                    # the epilogue: y and the thread's moments over its valid pixels
                    hh = h0 + pr[:, None] + 0 * cols
                    ww = w0 + cols
                    ok = (hh < h) & (ww < w)                       # [128, 8]
                    ls = np.zeros((THREADS, 8), np.float32)
                    lq = np.zeros((THREADS, 8), np.float32)
                    for p in range(8):
                        v = np.where(ok[:, p, None], acc[:, p], np.float32(0))
                        ls += v
                        lq += v * v
                    for t in range(THREADS):
                        for p in range(8):
                            if ok[t, p]:
                                for j in range(8):
                                    if co0 + chan[t, j] < co:
                                        y[bi, hh[t, p], ww[t, p], co0 + chan[t, j]] = acc[t, p, j]
                    # the 16 pixel groups of each channel, in order
                    red_s = np.zeros((THREADS // (BN // 8), BN), np.float32)
                    red_q = np.zeros_like(red_s)
                    for t in range(THREADS):
                        red_s[pg[t], chan[t]] = ls[t]
                        red_q[pg[t], chan[t]] = lq[t]
                    tot_s = np.zeros(BN, np.float32)
                    tot_q = np.zeros(BN, np.float32)
                    for g in range(red_s.shape[0]):
                        tot_s += red_s[g]
                        tot_q += red_q[g]
                    n_co = min(BN, co - co0)
                    row_s[co0:co0 + n_co] = tot_s[:n_co]
                    row_q[co0:co0 + n_co] = tot_q[:n_co]
                part_s.append(row_s)
                part_q.append(row_q)
    s = np.stack(part_s).sum(0, dtype=np.float32)
    q = np.stack(part_q).sum(0, dtype=np.float32)
    return (torch.from_numpy(y).permute(0, 3, 1, 2), torch.from_numpy(s), torch.from_numpy(q),
            len(part_s))


def test_thread_map_covers_the_tile_once():
    pr, pc0, chan, pg = thread_map()
    cells = {(int(pr[t]), int(pc0[t]) + p, int(c)) for t in range(THREADS) for p in range(8)
             for c in chan[t]}
    assert len(cells) == THREADS * 64 == TH * TW * BN
    assert cells == {(r, c, k) for r in range(TH) for c in range(TW) for k in range(BN)}
    # a warp's four pixel groups are four rows of the same columns; their staged rows
    # start on disjoint banks (a row holds (TW + 2) * chunk + 4 floats)
    pitch = (TW + 2) * cm.F32_CHUNK + 4
    for warp in range(THREADS // 32):
        lanes = np.arange(32) + 32 * warp
        assert len(set(pc0[lanes])) == 1 and len(set(pr[lanes])) == 4
        banks = [set((int(r) * pitch + k) % 32 for k in range(4)) for r in set(pr[lanes])]
        assert len(set().union(*banks)) == 16
    # the 8 channel groups of a pixel group read 128 contiguous bytes twice
    assert sorted(chan[:8, :4].ravel()) == list(range(32))
    assert sorted(chan[:8, 4:].ravel()) == list(range(32, 64))


@pytest.mark.parametrize("shape,co", [((2, 5, 12, 13), 7),       # Ci off a vector, ragged tile
                                      ((1, 8, 9, 17), 64),        # one chunk; W one past a tile
                                      ((1, 20, 7, 33), 72),       # a ragged last chunk, two blocks
                                      ((2, 16, 16, 16), 64)])     # whole tiles and chunks
def test_kernel_model_matches_the_plain_conv(shape, co):
    """atol 1e-5 of the summed magnitudes: fp32 sums in another order."""
    x, w = _case(shape, co)
    y, s, q, rows = kernel_model(x, w)
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    mag = F.conv2d(x.abs(), w.abs(), padding=1)
    assert rows == cm.scratch_rows(shape[0], *shape[2:])
    assert not torch.isnan(y).any()                               # every valid output written
    assert bool(((y - ry).abs() <= 1e-5 * mag).all())
    assert bool(((s - rs).abs() <= 1e-5 * ry.abs().sum(dim=(0, 2, 3))).all())
    assert bool(((q - rq).abs() <= 1e-5 * rq).all())


@pytest.mark.parametrize("chunk", [4, 16, 32])
def test_kernel_model_at_other_chunks(chunk):
    x, w = _case((1, 20, 9, 17), 7, seed=3)
    y, s, q, _ = kernel_model(x, w, chunk)
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    mag = F.conv2d(x.abs(), w.abs(), padding=1)
    assert bool(((y - ry).abs() <= 1e-5 * mag).all())
    assert bool(((s - rs).abs() <= 1e-5 * ry.abs().sum(dim=(0, 2, 3))).all())
    assert bool(((q - rq).abs() <= 1e-5 * rq).all())


@pytest.mark.parametrize("ci,co,ci_pad,co_pad", [(5, 7, 32, 64), (8, 64, 32, 64),
                                                 (20, 72, 32, 128), (64, 64, 64, 64),
                                                 (3, 2, 3, 2)])
def test_tap_major_weights_index_by_index(ci, co, ci_pad, co_pad):
    w = torch.from_numpy(np.random.RandomState(4).randn(co, ci, 3, 3).astype(np.float32))
    wk = cm.weights_tap_major(w, ci_pad, co_pad)
    assert wk.is_contiguous() and tuple(wk.shape) == (9, ci_pad, co_pad) and wk.dtype == w.dtype
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(wk[ky * 3 + kx, :ci, :co], w[:, :, ky, kx].t())
    assert not wk[:, ci:].any() and not wk[:, :, co:].any()


@pytest.mark.parametrize("ci,co", [(5, 7), (64, 64), (224, 64), (800, 512), (100, 130)])
def test_the_wrapper_pads_to_what_every_build_of_the_kernel_reads(ci, co):
    """ci_pad is a multiple of every chunk the kernel allows (4 to 32) and
    co_pad covers whole blocks of 64: the weight copies need no guard."""
    ci_pad, co_pad = cm._round_up(ci, cm.F32_CI_ALIGN), cm._round_up(co, cm.F32_CO_ALIGN)
    for chunk in (4, 8, 16, 32):
        assert ci_pad % chunk == 0 and ci_pad >= -(-ci // chunk) * chunk
    assert co_pad >= -(-co // BN) * BN and co_pad % 4 == 0
    if ci % 32 == 0 and co % 64 == 0:
        assert (ci_pad, co_pad) == (ci, co)                       # the step's shapes: no copy


def _source_constant(name: str) -> int:
    src = (_ext.CSRC / "conv_bn_stats.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_shared_memory_formula_matches_the_layout():
    # a stage of 8 channels: 10 rows x (18 x 8 + 4) floats of patch, 9 x 8 x 64 of weights
    assert cm.fp32_smem_bytes(8, 1) == 4 * (10 * 148 + 4608) == 24_352
    assert cm.fp32_smem_bytes(8, 3) == 73_056
    assert cm.fp32_smem_bytes(16, 2) == 2 * 4 * (10 * 292 + 9216)
    # two blocks of the built-in configuration fit an SM (1 KB a block is the system's)
    assert 2 * (cm.fp32_smem_bytes() + 1024) <= 233_472
    assert _source_constant("kF32BlocksPerSm") == 2
    # the moments' [2][16][64] floats go through the ring
    assert 2 * 16 * BN * 4 <= cm.fp32_smem_bytes(4, 2)
    assert _source_constant("kF32Chunk") == cm.F32_CHUNK
    assert _source_constant("kF32Stages") == cm.F32_STAGES
    assert _source_constant("kF32BN") == cm.F32_BLOCK_CO
    assert (_source_constant("kTH"), _source_constant("kTW")) == (cm.TILE_H, cm.TILE_W)
    assert "conv3x3_stats_kernel" not in (_ext.CSRC / "conv_bn_stats.cu").read_text()


class _FakeLibrary:
    """Stands for a loaded ctypes library: records calls, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn.startswith("__"):
            raise AttributeError(fn)

        def entry(*args):
            self.calls.append((fn, args))
            return 0
        return entry


@pytest.mark.parametrize("shape,co", [((2, 5, 12, 13), 7), ((1, 64, 9, 17), 128)])
def test_launch_arguments_fit_the_c_entry(monkeypatch, shape, co):
    """The fp32 launch hands the C entry x, the tap-major weights, y, the two
    scratch halves, s, q, then B, H, W, Ci, Co, the padded Ci and Co and the
    scratch rows (the stream is appended by ``_ext.call``)."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_ext, "_FNS", {})
    monkeypatch.setattr(_ext, "library", lambda name: fake)
    monkeypatch.setattr(_ext, "_current_device", lambda: 0)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 77)
    before = _ext.launch_counts()["conv_bn_stats"]
    x, w = _case(shape, co)
    y, s, q = cm._forward_cuda(x, w)
    assert _ext.launch_counts()["conv_bn_stats"] == before + 1
    (fn, args), = fake.calls
    b, ci, h, wd = shape
    tiles = cm.scratch_rows(b, h, wd)
    assert fn == "vaeunet_conv3x3_stats_f32"
    assert len(args) == len(_ext.SIGNATURES["conv_bn_stats"][fn])
    assert all(isinstance(a, int) for a in args)
    assert args[0] == x.data_ptr() and args[2] == y.data_ptr()
    assert args[4] - args[3] == 4 * tiles * co                    # the two scratch halves
    assert (args[5], args[6]) == (s.data_ptr(), q.data_ptr())
    assert args[7:] == (b, h, wd, ci, co, cm._round_up(ci, 32), cm._round_up(co, 64), tiles, 77)
    assert y.shape == (b, co, h, wd) and y.is_contiguous(memory_format=torch.channels_last)
    assert s.shape == q.shape == (co,) and s.dtype == torch.float32
