"""The tiled and row resize kernels' rule, on the CPU: a numpy fp32 model of
what a block of ``csrc/resize.cu`` does -- stage the span its tables name,
blend one axis into a buffer, the other from it -- against the plain
versions bit for bit; the span helpers and the shared memory they imply;
which route each shape takes; and the wrapper's direct launch where no
graph is recorded.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).  Inputs come from numpy seeds."""

import itertools

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import resize_mm

ONE = np.float32(1.0)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def tiled_forward_model(x: np.ndarray, out_hw, ac: bool, tile) -> np.ndarray:
    """x [B, H, W, C] fp32 -> y, tile by tile as resize_tiled_kernel does."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    h0, h1, lh = resize_mm.axis_table(h, oh, ac)
    w0, w1, lw = resize_mm.axis_table(w, ow, ac)
    hspan = resize_mm.forward_spans(h0, h1, tile[0])
    wspan = resize_mm.forward_spans(w0, w1, tile[1])
    y = np.full((b, oh, ow, c), np.nan, np.float32)
    for (th, (h_lo, sh)), (tw, (w_lo, sw)) in itertools.product(enumerate(hspan),
                                                                enumerate(wspan)):
        rows = slice(th * tile[0], min((th + 1) * tile[0], oh))
        cols = slice(tw * tile[1], min((tw + 1) * tile[1], ow))
        xs = x[:, h_lo:h_lo + sh, w_lo:w_lo + sw]              # A: the span, once
        assert xs.shape[1:3] == (sh, sw)
        lam = lw[cols][None, None, :, None]
        t = (ONE - lam) * xs[:, :, w0[cols] - w_lo] + lam * xs[:, :, w1[cols] - w_lo]   # B
        lam = lh[rows][None, :, None, None]
        y[:, rows, cols] = (ONE - lam) * t[:, h0[rows] - h_lo] + lam * t[:, h1[rows] - h_lo]  # C
    return y


def tiled_backward_model(g: np.ndarray, in_hw, ac: bool, tile) -> np.ndarray:
    """g [B, OH, OW, C] fp32 -> gx, tile by tile as resize_bwd_tiled_kernel
    does: lists relative to the span, both sums in list order from 0."""
    b, oh, ow, c = g.shape
    h, w = in_hw
    hp, hi, hw = resize_mm.transpose_table(h, oh, ac)
    wp, wi, ww = resize_mm.transpose_table(w, ow, ac)
    hspan, nnz_h = resize_mm.backward_spans(hp, hi, tile[0])
    wspan, nnz_w = resize_mm.backward_spans(wp, wi, tile[1])
    gx = np.full((b, h, w, c), np.nan, np.float32)
    for (th, (oh_lo, sh)), (tw, (ow_lo, sw)) in itertools.product(enumerate(hspan),
                                                                  enumerate(wspan)):
        h_a, h_b = th * tile[0], min((th + 1) * tile[0], h)
        w_a, w_b = tw * tile[1], min((tw + 1) * tile[1], w)
        assert hp[h_b] - hp[h_a] <= nnz_h and wp[w_b] - wp[w_a] <= nnz_w
        gs = g[:, oh_lo:oh_lo + sh, ow_lo:ow_lo + sw]          # A
        assert gs.shape[1:3] == (sh, sw)
        t = np.zeros((b, h_b - h_a, sw, c), np.float32)        # B
        for r in range(h_b - h_a):
            for m in range(hp[h_a + r], hp[h_a + r + 1]):
                t[:, r] = t[:, r] + hw[m] * gs[:, hi[m] - oh_lo]
        acc = np.zeros((b, h_b - h_a, w_b - w_a, c), np.float32)   # C
        for col in range(w_b - w_a):
            for k in range(wp[w_a + col], wp[w_a + col + 1]):
                acc[:, :, col] = acc[:, :, col] + ww[k] * t[:, :, wi[k] - ow_lo]
        gx[:, h_a:h_b, w_a:w_b] = acc
    return gx


# (input H, W), (output H, W): 2x up, odd up, down, out = 1, H kept, W kept
RESIZES = [((16, 24), (32, 48)), ((7, 5), (19, 12)), ((20, 30), (9, 13)), ((5, 6), (1, 1)),
           ((6, 6), (6, 11)), ((9, 4), (20, 4))]
TILES = [(16, 16), (8, 4), (4, 8), (1, 1)]       # most do not divide the sizes above


@pytest.mark.parametrize("in_hw,out_hw", RESIZES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", TILES)
def test_tiled_forward_model_equals_the_plain_version(in_hw, out_hw, ac, tile):
    x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
    ours = tiled_forward_model(x, out_hw, ac, tile)
    np.testing.assert_array_equal(ours, nhwc(resize_mm.resize_plain(nchw(x), out_hw, ac)))


@pytest.mark.parametrize("in_hw,out_hw", RESIZES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", TILES)
def test_tiled_backward_model_equals_the_plain_version(in_hw, out_hw, ac, tile):
    g = np.random.RandomState(1).randn(2, *out_hw, 3).astype(np.float32)
    ours = tiled_backward_model(g, in_hw, ac, tile)
    np.testing.assert_array_equal(ours, nhwc(resize_mm.resize_backward_plain(nchw(g), in_hw, ac)))


@pytest.mark.parametrize("ac", [True, False])
def test_tiled_models_in_bf16_round_once(ac):
    """bf16 tensors are blended and summed in fp32 and rounded at the store."""
    xb = torch.from_numpy(np.random.RandomState(2).randn(1, 9, 11, 8).astype(np.float32)).to(
        torch.bfloat16)                                          # NHWC
    y = torch.from_numpy(tiled_forward_model(xb.float().numpy(), (21, 17), ac, (8, 8)))
    ref = resize_mm.resize_plain(xb.permute(0, 3, 1, 2), (21, 17), ac)
    assert ref.dtype == torch.bfloat16
    assert torch.equal(y.to(torch.bfloat16).permute(0, 3, 1, 2), ref)
    gx = torch.from_numpy(tiled_backward_model(xb.float().numpy(), (4, 5), ac, (2, 4)))
    ref = resize_mm.resize_backward_plain(xb.permute(0, 3, 1, 2), (4, 5), ac)
    assert torch.equal(gx.to(torch.bfloat16).permute(0, 3, 1, 2), ref)


# ----- the span helpers ------------------------------------------------------

AXES = [(16, 32), (128, 256), (7, 19), (20, 9), (5, 1), (6, 6), (1, 4), (33, 100), (100, 33)]


@pytest.mark.parametrize("in_size,out_size", AXES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", [1, 4, 16])
def test_forward_spans_hold_every_index_their_tile_names(in_size, out_size, ac, tile):
    i0, i1, _ = resize_mm.axis_table(in_size, out_size, ac)
    spans = resize_mm.forward_spans(i0, i1, tile)
    assert spans.dtype == np.int32 and spans.shape == (-(-out_size // tile), 2)
    for t, (lo, n) in enumerate(spans):
        named = np.concatenate([i0[t * tile:(t + 1) * tile], i1[t * tile:(t + 1) * tile]])
        assert n >= 1 and 0 <= lo and lo + n <= in_size
        assert named.min() == lo and named.max() == lo + n - 1      # tight and contiguous
    assert (np.diff(spans[:, 0]) >= 0).all()      # monotone tables: the spans move one way


@pytest.mark.parametrize("in_size,out_size", AXES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", [1, 4, 8])
def test_backward_spans_hold_every_output_their_tile_reads(in_size, out_size, ac, tile):
    ptr, idx, _ = resize_mm.transpose_table(in_size, out_size, ac)
    spans, nnz = resize_mm.backward_spans(ptr, idx, tile)
    assert spans.dtype == np.int32 and spans.shape == (-(-in_size // tile), 2)
    covered = np.zeros(out_size, bool)
    for t, (lo, n) in enumerate(spans):
        seg = idx[ptr[t * tile]:ptr[min((t + 1) * tile, in_size)]]
        assert len(seg) <= nnz
        if len(seg) == 0:
            assert (lo, n) == (0, 0)            # a downsample: nobody reads these inputs
            continue
        assert seg.min() == lo and seg.max() == lo + n - 1 and lo + n <= out_size
        covered[seg] = True
    assert covered.all()                         # every output's gradient goes somewhere
    assert nnz == max(ptr[min((t + 1) * tile, in_size)] - ptr[t * tile]
                      for t in range(len(spans)))


def test_a_2x_upsample_tile_reads_about_half_its_size():
    for ac in (True, False):
        i0, i1, _ = resize_mm.axis_table(128, 256, ac)
        assert resize_mm.forward_spans(i0, i1, 16)[:, 1].max() <= 16 // 2 + 2
        ptr, idx, _ = resize_mm.transpose_table(128, 256, ac)
        spans, nnz = resize_mm.backward_spans(ptr, idx, 8)
        assert spans[:, 1].max() <= 2 * 8 + 3 and nnz == 2 * 2 * 8


# ----- plans, shared memory and routes ---------------------------------------

# (batch, element bytes) x (channels, input H = W, output H = W) of the request and the step
PATH_LAYERS = [(512, 16, 32), (512, 32, 64), (256, 64, 128), (128, 128, 256), (1, 256, 512)]
PATH = [(8, 4, *layer) for layer in PATH_LAYERS] + [(16, 2, *layer) for layer in PATH_LAYERS]


@pytest.mark.parametrize("batch,elem,c,size,out", PATH)
@pytest.mark.parametrize("backward", [False, True])
def test_path_shapes_route_and_shared_memory(batch, elem, c, size, out, backward):
    planner = resize_mm.plan_backward if backward else resize_mm.plan_forward
    plan = planner((size, size), (out, out), c, elem, True, batch)
    if c == 1 and backward:                     # the logits' gradient: vectors along gx's W
        vec = 16 // elem
        assert plan.route == "row" and (plan.tile_h, plan.tile_w // vec) == resize_mm.ROW_BWD_TILE
        assert plan.smem_bytes == resize_mm.row_bwd_smem_bytes(
            plan.tile_h, plan.tile_w, plan.span_h, plan.span_w, plan.nnz_h, plan.nnz_w, elem)
        assert 4 * plan.smem_bytes <= resize_mm.SMEM_LIMIT
        assert plan.blocks == batch * (size // plan.tile_h) * (size // plan.tile_w) >= 3 * 132
        return
    if c == 1:                                  # the logits resize: vectors along W
        assert plan.route == "row" and (plan.tile_h, plan.tile_w) == resize_mm.ROW_TILE
        assert plan.smem_bytes == resize_mm.row_smem_bytes(plan.tile_h, plan.tile_w,
                                                           plan.span_h, plan.span_w, elem)
        assert 4 * plan.smem_bytes <= resize_mm.SMEM_LIMIT
        assert plan.blocks == batch * (out // plan.tile_h) * (out // plan.tile_w) >= 32
        return
    assert plan.route == "tiled"
    assert (plan.tile_h, plan.tile_w) == (resize_mm.BACKWARD_TILE if backward
                                          else resize_mm.FORWARD_TILE)
    assert plan.lanes * plan.chunks * resize_mm.VEC_BYTES == c * elem
    assert plan.smem_bytes <= resize_mm.SMEM_BUDGET < resize_mm.SMEM_LIMIT == 232_448
    assert 2 * plan.smem_bytes <= resize_mm.SMEM_LIMIT      # two blocks on an SM
    assert plan.blocks >= 3 * 132                           # several waves of the card's SMs
    own = size if backward else out
    tiles = -(-own // plan.tile_h) * -(-own // plan.tile_w)
    assert plan.blocks == batch * tiles * plan.chunks


@pytest.mark.parametrize("c,elem,route", [(1, 4, "scalar"), (3, 4, "scalar"), (4, 2, "scalar"),
                                          (4, 4, "tiled"), (8, 2, "tiled"), (72, 4, "tiled"),
                                          (12, 2, "scalar"), (6, 4, "scalar")])
def test_route_follows_the_bytes_of_a_pixel(c, elem, route):
    """Tiled exactly where a pixel's channels are whole 16-byte vectors."""
    for planner in (resize_mm.plan_forward, resize_mm.plan_backward):
        assert planner((9, 11), (21, 17), c, elem, False, 2).route == route


def test_shared_memory_formula_matches_the_layout():
    # forward fp32 16x16 tile, 8 lanes, span 10x10: tables 384 B, x 12,800 B, t 20,480 B
    assert resize_mm.tiled_smem_bytes(False, 16, 16, 8, 10, 10, 0, 0, 4) == 384 + 12800 + 20480
    # bf16 keeps t as two fp32 planes
    assert resize_mm.tiled_smem_bytes(False, 16, 16, 8, 10, 10, 0, 0, 2) == 384 + 12800 + 40960
    # backward 8x8, span 18x18, 32 pairs an axis: lists 4 (9 + 9 + 128) -> 592
    assert resize_mm.tiled_smem_bytes(True, 8, 8, 8, 18, 18, 32, 32, 4) == 592 + 41472 + 18432


@pytest.mark.parametrize("backward", [False, True])
def test_long_spans_shrink_the_tile_until_it_fits(backward):
    """A strong downsample reads far apart: the tile is halved along the
    longer span until the block fits the budget; 1x1 always does."""
    planner = resize_mm.plan_backward if backward else resize_mm.plan_forward
    plan = planner((1000, 40), (3, 90), 64, 4, False, 1)
    assert plan.route == "tiled" and plan.smem_bytes <= resize_mm.SMEM_BUDGET
    if not backward:
        assert plan.tile_h < resize_mm.FORWARD_TILE[0]
    with pytest.raises(ValueError, match="shared memory"):
        resize_mm.plan_forward((1000, 1000), (3, 3), 64, 4, False, 1, tile=(4, 4), lanes=8)


def test_few_channels_grow_the_tile():
    plan = resize_mm.plan_forward((64, 64), (128, 128), 4, 4, True, 2)
    th, tw = resize_mm.FORWARD_TILE
    assert plan.lanes == 1 and plan.tile_h * plan.tile_w == th * tw * resize_mm.FORWARD_LANES
    small = resize_mm.plan_forward((3, 3), (5, 5), 4, 4, True, 2)
    assert (small.tile_h, small.tile_w) == (8, 8)           # no larger than the output needs


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("c,dtype", [(8, torch.float32), (8, torch.bfloat16), (1, torch.float32),
                                     (3, torch.bfloat16)])
def test_launch_arguments_fit_the_c_entries(backward, c, dtype):
    """The wrapper's argument list has the length and the entry the C
    interface declares (the stream is appended by ``_ext.call``)."""
    small = torch.zeros((2, c, 5, 6), dtype=dtype).contiguous(memory_format=torch.channels_last)
    large = torch.zeros((2, c, 11, 9), dtype=dtype).contiguous(memory_format=torch.channels_last)
    src, dst = (large, small) if backward else (small, large)
    fn, args = resize_mm.launch_args(src, dst, False, backward=backward)
    tiled = (c * src.element_size()) % 16 == 0
    stem = "vaeunet_resize_bwd" if backward else "vaeunet_resize"
    assert fn == f"{stem}{'' if tiled else '_scalar'}_{'f32' if dtype == torch.float32 else 'bf16'}"
    assert len(args) + 1 == len(_ext.SIGNATURES["resize"][fn])
    assert args[:2] == (src.data_ptr(), dst.data_ptr()) and all(isinstance(a, int) for a in args)
    assert args[-6 - (0 if not tiled else 6 if backward else 4):][:6] == (2, 5, 6, c, 11, 9)
    if tiled:
        planner = resize_mm.plan_backward if backward else resize_mm.plan_forward
        plan = planner((5, 6), (11, 9), c, src.element_size(), False, 2)
        assert args[-1] == plan.smem_bytes
        assert (1 << args[16], 1 << args[17], 1 << args[18]) == plan[1:4]


def test_a_tensor_off_a_16_byte_address_takes_the_scalar_route():
    base = torch.zeros(2 * 8 * 5 * 6 + 1)
    x = base[1:].view(2, 5, 6, 8).permute(0, 3, 1, 2)       # channels_last, 4 bytes off
    y = torch.zeros((2, 8, 11, 9)).contiguous(memory_format=torch.channels_last)
    assert x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 == 4
    assert resize_mm.launch_args(x, y, True)[0] == "vaeunet_resize_scalar_f32"
    assert resize_mm.launch_args(y, x, True, backward=True)[0] == "vaeunet_resize_bwd_scalar_f32"
    assert resize_mm.launch_args(x.clone(memory_format=torch.channels_last), y,
                                 True)[0] == "vaeunet_resize_f32"


# ----- the row route (C = 1) -------------------------------------------------

def row_forward_model(x: np.ndarray, out_hw, ac: bool, tile, vec: int) -> np.ndarray:
    """x [B, H, W] fp32 -> y, block by block as resize_row_kernel does: the
    span's first column rounded down to a vector of `vec` elements, a staged
    row every ``row_pitch`` elements, table entries relative to the span."""
    b, h, w = x.shape
    oh, ow = out_hw
    assert ow % vec == 0 and tile[1] % vec == 0
    h0, h1, lh = resize_mm.axis_table(h, oh, ac)
    w0, w1, lw = resize_mm.axis_table(w, ow, ac)
    hspan = resize_mm.forward_spans(h0, h1, tile[0])
    wspan = resize_mm.forward_spans(w0, w1, tile[1])
    pitch = resize_mm.row_pitch(int(wspan[:, 1].max()), 16 // vec)
    y = np.full((b, oh, ow), np.nan, np.float32)
    for (th, (h_lo, sh)), (tw, (w_first, sw)) in itertools.product(enumerate(hspan),
                                                                   enumerate(wspan)):
        rows = slice(th * tile[0], min((th + 1) * tile[0], oh))
        cols = slice(tw * tile[1], min((tw + 1) * tile[1], ow))
        w_lo, w_hi = w_first // vec * vec, w_first + sw
        assert w_hi - w_lo <= pitch and pitch % vec == 0
        xs = np.full((b, sh, pitch), np.nan, np.float32)                   # A
        xs[:, :, :w_hi - w_lo] = x[:, h_lo:h_lo + sh, w_lo:w_hi]
        lam = lw[cols][None, None, :]
        t = (ONE - lam) * xs[:, :, w0[cols] - w_lo] + lam * xs[:, :, w1[cols] - w_lo]   # B
        lam = lh[rows][None, :, None]
        y[:, rows, cols] = (ONE - lam) * t[:, h0[rows] - h_lo] + lam * t[:, h1[rows] - h_lo]  # C
    return y


# (input H, W), (output H, W multiple of 8): 2x up, odd up, down, H kept, W kept
ROW_RESIZES = [((16, 24), (32, 48)), ((7, 5), (19, 16)), ((20, 30), (9, 8)), ((6, 6), (6, 24)),
               ((9, 8), (20, 8))]
ROW_TILES = [(16, 32), (4, 8), (1, 8), (8, 16)]       # most do not divide the sizes above


@pytest.mark.parametrize("in_hw,out_hw", ROW_RESIZES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", ROW_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_forward_model_equals_the_plain_version(in_hw, out_hw, ac, tile, dtype):
    """Bit for bit; bf16 is blended in fp32 and rounded once at the store."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, *in_hw).astype(np.float32)).to(dtype)
    vec = 16 // x.element_size()
    ours = torch.from_numpy(row_forward_model(x.float().numpy(), out_hw, ac, tile, vec)).to(dtype)
    ref = resize_mm.resize_plain(x[:, None], out_hw, ac)
    assert ref.dtype == dtype and torch.equal(ours[:, None], ref)


@pytest.mark.parametrize("c,elem,out_w,forward,backward", [
    (1, 4, 512, "row", "row"), (1, 2, 512, "row", "row"),   # the logits resize
    (1, 4, 20, "row", "row"), (1, 2, 24, "row", "row"),
    (1, 4, 18, "scalar", "scalar"), (1, 2, 20, "scalar", "scalar"),   # a row off a vector
    (3, 4, 512, "scalar", "scalar"), (4, 2, 512, "scalar", "scalar"),
    (4, 4, 512, "tiled", "tiled"), (8, 2, 512, "tiled", "tiled")])
def test_route_rule_of_the_one_channel_resize(c, elem, out_w, forward, backward):
    """C = 1 with a result row of whole 16-byte vectors (y forward, gx
    backward) takes the row route both ways; every other shape keeps the
    route it had."""
    assert resize_mm.plan_forward((9, 11), (21, out_w), c, elem, True, 2).route == forward
    assert resize_mm.plan_backward((21, out_w), (9, 11), c, elem, True, 2).route == backward


def test_row_shared_memory_formula_matches_the_layout():
    # fp32 16 x 128 outputs, span 10 x 66: tables 12 (16 + 128) = 1728 B; a staged row of
    # 66 + 3 -> 72 floats, 10 of them 2,880 B; t 10 x 128 fp32 5,120 B
    assert resize_mm.row_pitch(66, 4) == 72 and resize_mm.row_pitch(66, 2) == 80
    assert resize_mm.row_smem_bytes(16, 128, 10, 66, 4) == 1728 + 2880 + 5120
    # bf16: 66 + 7 -> 80 elements of 2 bytes; t stays fp32
    assert resize_mm.row_smem_bytes(16, 128, 10, 66, 2) == 1728 + 1600 + 5120
    # the staged span is rounded up to 16 bytes: 3 rows of 8 bf16
    assert resize_mm.row_pitch(1, 2) == 8 and resize_mm.row_pitch(2, 4) == 8
    assert resize_mm.row_smem_bytes(1, 8, 3, 1, 2) == 112 + 48 + 96


def test_row_route_shrinks_its_tile_for_a_strong_downsample():
    plan = resize_mm.plan_forward((4000, 4000), (64, 64), 1, 4, False, 1)
    assert plan.route == "row" and plan.smem_bytes <= resize_mm.SMEM_BUDGET
    assert plan.tile_h * plan.tile_w < 64 * 64 and plan.tile_w % 4 == 0
    small = resize_mm.plan_forward((3, 3), (5, 8), 1, 2, True, 2)
    assert (small.tile_h, small.tile_w) == (8, 8)            # no larger than the output needs
    with pytest.raises(ValueError, match="shared memory"):
        resize_mm.plan_forward((100000, 8), (8, 8), 1, 4, False, 1, tile=(8, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_launch_arguments_fit_the_c_entry(dtype):
    x = torch.zeros((2, 1, 16, 24), dtype=dtype).contiguous(memory_format=torch.channels_last)
    y = torch.zeros((2, 1, 32, 48), dtype=dtype).contiguous(memory_format=torch.channels_last)
    fn, args = resize_mm.launch_args(x, y, True)
    assert fn == f"vaeunet_resize_row_{'f32' if dtype == torch.float32 else 'bf16'}"
    assert len(args) + 1 == len(_ext.SIGNATURES["resize"][fn])
    assert args[:2] == (x.data_ptr(), y.data_ptr()) and all(isinstance(a, int) for a in args)
    plan = resize_mm.plan_forward((16, 24), (32, 48), 1, x.element_size(), True, 2)
    vec = 16 // x.element_size()
    assert args[10:16] == (2, 16, 24, 1, 32, 48)
    assert (1 << args[16], (1 << args[17]) * vec) == (plan.tile_h, plan.tile_w)
    assert args[18:] == (resize_mm.row_pitch(plan.span_w, x.element_size()), plan.smem_bytes)
    # the scalar kernel on the same tensors, and a tensor off a 16-byte address
    assert resize_mm.launch_args(x, y, True, scalar=True)[0].count("_scalar_") == 1
    base = torch.zeros(2 * 16 * 24 + 4, dtype=dtype)
    off = base[1:1 + 2 * 16 * 24].view(2, 16, 24, 1).permute(0, 3, 1, 2)
    assert off.data_ptr() % 16 != 0
    assert resize_mm.launch_args(off, y, True)[0].count("_scalar_") == 1
    # a second lookup of the same launch is served from the per-shape cache
    n = len(resize_mm._SETUPS)
    assert resize_mm.launch_args(x, y, True) == (fn, args) and len(resize_mm._SETUPS) == n


def test_wrapper_launches_directly_unless_a_graph_is_recorded(monkeypatch):
    """Without a graph to record (no grad mode, inference mode, or an input
    that does not require grad) the launch does not go through
    ``Function.apply``; with one, the result carries a grad_fn whose backward
    is the gradient kernel's wrapper.  The launch itself is stubbed."""
    launched, applied = [], []
    monkeypatch.setattr(_ext, "call", lambda lib, fn, dev, *args: launched.append(fn))
    real_apply = resize_mm._ResizeCuda.apply
    monkeypatch.setattr(resize_mm._ResizeCuda, "apply",
                        lambda *a: applied.append(1) or real_apply(*a))
    x = torch.zeros((2, 1, 8, 8)).contiguous(memory_format=torch.channels_last)
    before = _ext.launch_counts()["resize"]
    for ctx, leaf in ((torch.no_grad(), x.clone().requires_grad_()),
                      (torch.inference_mode(), x), (torch.enable_grad(), x)):
        with ctx:
            y = resize_mm._launch_or_record(leaf, 16, 16, True)
        assert y.grad_fn is None and not y.requires_grad and tuple(y.shape) == (2, 1, 16, 16)
    assert applied == [] and launched == ["vaeunet_resize_row_f32"] * 3
    leaf = x.clone().requires_grad_()
    y = resize_mm._launch_or_record(leaf, 16, 16, True)
    assert applied == [1] and len(launched) == 4 and y.grad_fn is not None
    assert _ext.launch_counts()["resize"] == before + 4
    y.backward(torch.ones_like(y))                 # a CPU cotangent: the plain gradient
    assert leaf.grad is not None and torch.equal(
        leaf.grad, resize_mm.resize_backward_plain(torch.ones_like(y), (8, 8), True))
