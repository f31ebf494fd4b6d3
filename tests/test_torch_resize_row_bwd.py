"""The one-channel resize gradient's row route, on the CPU: a numpy fp32
model of what a block of ``resize_row_bwd_kernel`` (``csrc/resize.cu``)
does -- stage the g span its tile's lists name (the first column rounded
down to a vector), sum H^T once per (gx row, span column) into an fp32
buffer, then W^T from it, rounded once -- against the plain version bit for
bit in both types; the plan's tile, spans and shared memory; and the
launch arguments against the C entry.  The kernel itself runs only on the
card (``tests/test_torch_cuda_kernels2.py``).  Inputs come from numpy
seeds."""

import itertools

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import resize_mm


def row_backward_model(g: np.ndarray, in_hw, ac: bool, tile, vec: int) -> np.ndarray:
    """g [B, OH, OW] fp32 -> gx [B, H, W], block by block: `tile` is gx
    rows x columns (columns a multiple of `vec`); lists relative to the
    span, both sums in list order from 0."""
    b, oh, ow = g.shape
    h, w = in_hw
    assert w % vec == 0 and tile[1] % vec == 0
    hp, hi, hw = resize_mm.transpose_table(h, oh, ac)
    wp, wi, ww = resize_mm.transpose_table(w, ow, ac)
    hspan, nnz_h = resize_mm.backward_spans(hp, hi, tile[0])
    wspan, nnz_w = resize_mm.backward_spans(wp, wi, tile[1])
    pitch = resize_mm.row_pitch(int(wspan[:, 1].max()), 16 // vec)
    gx = np.full((b, h, w), np.nan, np.float32)
    for (th, (oh_lo, sh)), (tw, (ow_first, sw)) in itertools.product(enumerate(hspan),
                                                                     enumerate(wspan)):
        h_a, h_b = th * tile[0], min((th + 1) * tile[0], h)
        w_a, w_b = tw * tile[1], min((tw + 1) * tile[1], w)
        assert hp[h_b] - hp[h_a] <= nnz_h and wp[w_b] - wp[w_a] <= nnz_w
        ow_lo, ow_hi = ow_first // vec * vec, ow_first + sw
        nv = -(-(ow_hi - ow_lo) // vec)
        assert nv * vec <= pitch and pitch % vec == 0 and ow_lo + nv * vec <= max(ow, vec)
        gs = np.full((b, sh, pitch), np.nan, np.float32)                     # A
        gs[:, :, :ow_hi - ow_lo] = g[:, oh_lo:oh_lo + sh, ow_lo:ow_hi]
        t = np.zeros((b, tile[0], nv * vec), np.float32)                      # B
        for r in range(h_b - h_a):
            for m in range(hp[h_a + r], hp[h_a + r + 1]):
                t[:, r] = t[:, r] + hw[m] * gs[:, hi[m] - oh_lo, :nv * vec]
        acc = np.zeros((b, h_b - h_a, w_b - w_a), np.float32)                 # C
        for col in range(w_b - w_a):
            for k in range(wp[w_a + col], wp[w_a + col + 1]):
                acc[:, :, col] = acc[:, :, col] + ww[k] * t[:, :h_b - h_a, wi[k] - ow_lo]
        gx[:, h_a:h_b, w_a:w_b] = acc
    return gx


# (gx H, W), (g H, W): 2x up (the logits' gradient), odd up, the gradients
# of downsamples by 4, 8 and 16, H kept, W kept, ragged edges
ROW_BWD_RESIZES = [((16, 24), (32, 48)), ((7, 8), (19, 16)), ((64, 64), (16, 16)),
                   ((64, 64), (8, 8)), ((64, 64), (4, 4)), ((6, 8), (6, 24)),
                   ((9, 16), (20, 16)), ((33, 40), (66, 80))]
ROW_BWD_TILES = [(8, 16), (4, 8), (1, 8), (16, 32)]       # most do not divide the sizes above


@pytest.mark.parametrize("in_hw,out_hw", ROW_BWD_RESIZES)
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("tile", ROW_BWD_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_backward_model_equals_the_plain_version(in_hw, out_hw, ac, tile, dtype):
    """Bit for bit; bf16 is summed in fp32 and rounded once at the store."""
    g = torch.from_numpy(np.random.RandomState(6).randn(2, *out_hw).astype(np.float32)).to(dtype)
    vec = 16 // g.element_size()
    ours = row_backward_model(g.float().numpy(), in_hw, ac, tile, vec)
    ref = resize_mm.resize_backward_plain(g[:, None], in_hw, ac)
    assert ref.dtype == dtype
    assert torch.equal(torch.from_numpy(ours).to(dtype)[:, None], ref)


@pytest.mark.parametrize("in_hw,out_hw", ROW_BWD_RESIZES + [((256, 256), (512, 512))])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("elem", [4, 2])
def test_plan_takes_the_row_route_and_fits(in_hw, out_hw, ac, elem):
    """gx's row is whole vectors in both types here: the row route, a tile
    of whole vectors no larger than gx needs, the block within the budget,
    its shared memory from the layout's formula and the spans the
    tile's lists name."""
    plan = resize_mm.plan_backward(in_hw, out_hw, 1, elem, ac, 2)
    vec = 16 // elem
    assert plan.route == "row" and plan.tile_w % vec == 0
    assert plan.tile_h <= max(1, 1 << (in_hw[0] - 1).bit_length())
    assert plan.smem_bytes <= resize_mm.SMEM_BUDGET
    hp, hi, _ = resize_mm.transpose_table(in_hw[0], out_hw[0], ac)
    wp, wi, _ = resize_mm.transpose_table(in_hw[1], out_hw[1], ac)
    hspan, nnz_h = resize_mm.backward_spans(hp, hi, plan.tile_h)
    wspan, nnz_w = resize_mm.backward_spans(wp, wi, plan.tile_w)
    assert (plan.span_h, plan.span_w) == (hspan[:, 1].max(), wspan[:, 1].max())
    assert (plan.nnz_h, plan.nnz_w) == (nnz_h, nnz_w)
    assert plan.smem_bytes == resize_mm.row_bwd_smem_bytes(
        plan.tile_h, plan.tile_w, plan.span_h, plan.span_w, nnz_h, nnz_w, elem)
    assert plan.blocks == 2 * -(-in_hw[0] // plan.tile_h) * -(-in_hw[1] // plan.tile_w)


def test_row_bwd_shared_memory_formula_matches_the_layout():
    # fp32 8 x 128 gx, span 18 x 257, 32 + 512 pairs: lists 4 (9 + 129 + 2 x 544) = 4,904 B,
    # rounded up to 16 bytes 4,912 B; a staged row of 257 + 3 -> 260 floats, 18 of them
    # 18,720 B; t 8 x 260 fp32 8,320 B; the tile's gx 8 x 128 x 4 = 4,096 B
    assert resize_mm.row_bwd_smem_bytes(8, 128, 18, 257, 32, 512, 4) == (
        4912 + 18720 + 8320 + 4096)
    # bf16: a staged row of 257 + 7 -> 264 elements of 2 bytes; t stays fp32
    assert resize_mm.row_bwd_smem_bytes(8, 128, 18, 257, 32, 512, 2) == (
        4912 + 9504 + 8448 + 2048)


def test_the_step_shape_takes_the_default_tile():
    for elem, ac in itertools.product((4, 2), (True, False)):
        plan = resize_mm.plan_backward((256, 256), (512, 512), 1, elem, ac, 16)
        assert (plan.tile_h, plan.tile_w // (16 // elem)) == resize_mm.ROW_BWD_TILE
        assert plan.blocks == 16 * (256 // plan.tile_h) * (256 // plan.tile_w)


def test_a_block_that_cannot_fit_takes_the_scalar_route():
    """A strong upsample read backward names long spans: the tile shrinks
    until the block fits the budget; where one row of one vector cannot
    fit the card, the scalar route; a fixed tile that cannot fit raises."""
    plan = resize_mm.plan_backward((4000, 64), (3, 4000), 1, 4, False, 1)
    assert plan.route == "row" and plan.smem_bytes <= resize_mm.SMEM_BUDGET
    assert plan.tile_h * plan.tile_w < resize_mm.ROW_BWD_TILE[0] * resize_mm.ROW_BWD_TILE[1] * 4
    assert resize_mm.plan_backward((8, 8), (8, 200_000), 1, 4, False, 1).route == "scalar"
    with pytest.raises(ValueError, match="shared memory"):
        resize_mm.plan_backward((8, 8), (8, 200_000), 1, 4, False, 1, tile=(8, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_bwd_launch_arguments_fit_the_c_entry(dtype):
    g = torch.zeros((2, 1, 32, 48), dtype=dtype).contiguous(memory_format=torch.channels_last)
    gx = torch.zeros((2, 1, 16, 24), dtype=dtype).contiguous(memory_format=torch.channels_last)
    fn, args = resize_mm.launch_args(g, gx, True, backward=True)
    assert fn == f"vaeunet_resize_row_bwd_{'f32' if dtype == torch.float32 else 'bf16'}"
    assert len(args) + 1 == len(_ext.SIGNATURES["resize"][fn])
    assert args[:2] == (g.data_ptr(), gx.data_ptr()) and all(isinstance(a, int) for a in args)
    plan = resize_mm.plan_backward((16, 24), (32, 48), 1, g.element_size(), True, 2)
    vec = 16 // g.element_size()
    assert args[10:16] == (2, 16, 24, 1, 32, 48)
    assert (1 << args[16], (1 << args[17]) * vec) == (plan.tile_h, plan.tile_w)
    assert args[18:] == (resize_mm.row_pitch(plan.span_w, g.element_size()), plan.nnz_h,
                         plan.nnz_w, plan.smem_bytes)
    # the scalar kernel on the same tensors, and a gradient off a 16-byte address
    assert resize_mm.launch_args(g, gx, True, backward=True,
                                 scalar=True)[0].count("_bwd_scalar_") == 1
    base = torch.zeros(2 * 16 * 24 + 4, dtype=dtype)
    off = base[1:1 + 2 * 16 * 24].view(2, 16, 24, 1).permute(0, 3, 1, 2)
    assert off.data_ptr() % 16 != 0
    assert resize_mm.launch_args(g, off, True, backward=True)[0].count("_bwd_scalar_") == 1


def test_a_gx_row_off_a_vector_keeps_the_scalar_route():
    for elem, w in ((4, 18), (2, 20), (2, 12)):
        assert resize_mm.plan_backward((9, w), (21, 40), 1, elem, True, 2).route == "scalar"
