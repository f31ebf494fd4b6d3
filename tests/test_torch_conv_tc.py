"""What surrounds the bf16 tensor-core conv kernel, on the CPU: the
wrapper's K-major weights and channel padding, the scratch-row count, a
model in torch of the kernel's indexing (TMA boxes, tap order, masks, one
partial-moment row per tile) held against the plain conv, and the launch
path's binding cache in ``ops/_ext.py`` with a fake library."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats as cm

CHUNK = 64          # input channels per K step (csrc/conv_bn_stats.cu kChunk)


def _case(shape, co, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy((rng.randn(co, shape[1], 3, 3) * 0.2).astype(np.float32))
    return x, w


def _oihw(w9: torch.Tensor) -> torch.Tensor:
    """The inverse of weights_k_major: [9, Co, Ci] (tap = kx * 3 + ky) -> OIHW."""
    co, ci = w9.shape[1:]
    return w9.view(3, 3, co, ci).permute(2, 3, 1, 0)


def _box(t: torch.Tensor, starts, sizes) -> torch.Tensor:
    """A TMA tiled box of `t`: elements outside t read as zero, negative
    starts included."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for s, n, dim in zip(starts, sizes, t.shape):
        lo, hi = max(s, 0), min(s + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)]
    return out


def kernel_model(x: torch.Tensor, weight: torch.Tensor):
    """conv3x3_stats_wgmma_kernel's arithmetic, step for step in float64,
    from the operands the wrapper hands it.  -> y, s, q, scratch rows."""
    b, ci, h, w = x.shape
    co = weight.shape[0]
    ci_k = -(-ci // cm.CI_ALIGN) * cm.CI_ALIGN
    xk = cm.pad_channels(x, ci_k).permute(0, 2, 3, 1).double()       # NHWC
    wk = cm.weights_k_major(weight, ci_k).double()                    # [9, Co, Ci]
    bn = 64 if co <= 64 else 128
    th, tw = cm.TILE_H, cm.TILE_W
    y = torch.zeros((b, h, w, co), dtype=torch.float64)
    rows = []
    for bi in range(b):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                acc = torch.zeros((th * tw, -(-co // bn) * bn), dtype=torch.float64)
                for co0 in range(0, co, bn):
                    for chunk in range(-(-ci_k // CHUNK)):
                        for kx in range(3):
                            # box {64 ch, 16 w, 10 h, 1 b} at (ci0, w0 + kx - 1, h0 - 1, b)
                            patch = _box(xk[bi], (h0 - 1, w0 + kx - 1, chunk * CHUNK),
                                         (th + 2, tw, CHUNK))
                            # box {64, BN, 3} at (ci0, co0, 3 kx): taps ky = 0, 1, 2
                            wb = _box(wk, (3 * kx, co0, chunk * CHUNK), (3, bn, CHUNK))
                            for ky in range(3):
                                a = patch[ky:ky + th].reshape(th * tw, CHUNK)
                                acc[:, co0:co0 + bn] += a @ wb[ky].T
                pix = acc[:, :co].view(th, tw, co)
                vh, vw = min(th, h - h0), min(tw, w - w0)
                valid = pix[:vh, :vw]
                y[bi, h0:h0 + vh, w0:w0 + vw] = valid
                rows.append((valid.sum(dim=(0, 1)), (valid * valid).sum(dim=(0, 1))))
    s = torch.stack([r[0] for r in rows]).sum(0)
    q = torch.stack([r[1] for r in rows]).sum(0)
    return y.permute(0, 3, 1, 2), s, q, len(rows)


@pytest.mark.parametrize("shape,co", [((2, 5, 12, 13), 7),      # Ci % 8 != 0, ragged tile
                                      ((1, 70, 9, 17), 64),      # two chunks, the second ragged
                                      ((1, 16, 20, 33), 130)])   # three channel blocks of 128
def test_kernel_model_matches_the_plain_conv(shape, co):
    x, w = _case(shape, co)
    y, s, q, rows = kernel_model(x, w)
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    assert rows == cm.scratch_rows(shape[0], *shape[2:])
    torch.testing.assert_close(y.float(), ry, atol=1e-5, rtol=0)
    torch.testing.assert_close(s.float(), rs, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(q.float(), rq, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("ci,ci_k", [(5, 8), (8, 8), (224, 224), (3, 16)])
def test_k_major_weights_and_channel_padding_leave_the_conv_unchanged(ci, ci_k):
    x, w = _case((2, ci, 7, 11), 6, seed=1)
    xp = cm.pad_channels(x, ci_k)
    w9 = cm.weights_k_major(w, ci_k)
    assert xp.is_contiguous(memory_format=torch.channels_last) and w9.is_contiguous()
    assert tuple(w9.shape) == (9, 6, ci_k)
    assert torch.equal(xp[:, :ci], x) and not xp[:, ci:].any() and not w9[..., ci:].any()
    for kx in range(3):
        for ky in range(3):
            assert torch.equal(w9[kx * 3 + ky, :, :ci], w[:, :, ky, kx])
    y, s, q = cm.conv3x3_bn_stats_plain(xp, _oihw(w9))
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    torch.testing.assert_close(y, ry, atol=1e-6, rtol=0)
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(q, rq, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(8, 16), (12, 13), (1, 1), (17, 35), (256, 256), (9, 33)])
def test_scratch_rows_equal_the_tile_count(h, w):
    origins = {(h0, w0) for r in range(h) for c in range(w)
               for h0, w0 in [((r // cm.TILE_H) * cm.TILE_H, (c // cm.TILE_W) * cm.TILE_W)]}
    assert cm.scratch_rows(3, h, w) == 3 * len(origins)
    assert len(origins) == math.ceil(h / 8) * math.ceil(w / 16)


class _FakeLibrary:
    """Stands for a loaded ctypes library: counts lookups, returns `rc`."""

    def __init__(self):
        self.lookups = 0
        self.calls = []
        self.rc = 0

    def __getattr__(self, fn):
        if fn.startswith("__"):
            raise AttributeError(fn)
        self.lookups += 1

        def entry(*args):
            self.calls.append((fn, args))
            return self.rc
        return entry


def test_ext_call_binds_each_entry_once_and_raises_on_an_error(monkeypatch):
    fake = _FakeLibrary()
    loads = []
    monkeypatch.setattr(_ext, "_FNS", {})
    monkeypatch.setattr(_ext, "library", lambda name: loads.append(name) or fake)
    monkeypatch.setattr(_ext, "_current_device", lambda: 0)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 1234)
    dev = torch.device("cuda", 0)
    for _ in range(3):
        _ext.call("reparam", "vaeunet_normal", dev, 1, 2, 3)
        _ext.call("reparam", "vaeunet_reparam", torch.device("cuda"), 4)
    assert fake.lookups == 2 and loads == ["reparam", "reparam"]
    assert fake.calls[0] == ("vaeunet_normal", (1, 2, 3, 1234))     # stream appended
    assert fake.calls[1] == ("vaeunet_reparam", (4, 1234))
    fake.rc = 700
    with pytest.raises(RuntimeError, match="vaeunet_normal failed with CUDA error 700"):
        _ext.call("reparam", "vaeunet_normal", dev, 1, 2, 3)
    assert fake.lookups == 2


def test_ext_call_enters_another_device_for_its_stream(monkeypatch):
    """On the current device (or an unindexed one) the stream is read as it
    is; another device's launch enters that device first."""
    fake = _FakeLibrary()
    entered = []
    state = {"device": 0}

    class _Ctx:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)
            state["device"] = self.device.index

        def __exit__(self, *exc):
            state["device"] = 0
            return False

    monkeypatch.setattr(_ext, "_FNS", {})
    monkeypatch.setattr(_ext, "library", lambda name: fake)
    monkeypatch.setattr(_ext, "_current_device", lambda: state["device"])
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 100 + state["device"])
    monkeypatch.setattr(torch.cuda, "device", _Ctx)
    _ext.call("bn_relu", "f", torch.device("cuda", 0), 7)
    _ext.call("bn_relu", "f", torch.device("cuda"), 8)
    assert entered == [] and fake.calls == [("f", (7, 100)), ("f", (8, 100))]
    _ext.call("bn_relu", "f", torch.device("cuda", 2), 9)
    assert entered == [torch.device("cuda", 2)] and fake.calls[-1] == ("f", (9, 102))
    assert state["device"] == 0
