"""Bilinear resize along H and W and its gradient: the CUDA kernels'
wrappers and their plain versions.  Port of
``vaeunet_tpu/ops/pallas/resize_mm.py`` (``resize_h`` and ``resize_w``, and
their VJP ``_make_op`` / ``resize_h_op`` / ``resize_w_op``).

The JAX kernels contract one axis with the dense [out, in] interpolation
matrix.  Its rows have two nonzeros, (1 - lambda) at i0 and lambda at i1, so
the port keeps the per-axis tables instead and ``csrc/resize.cu`` blends the
four neighbours of both axes in one pass.  The tables come from
:func:`_source_coords`, a copy of ``vaeunet_tpu/ops/resize.py``'s fp32
coordinate rule, so the port and the JAX package interpolate from the same
coordinates.  ``x`` is NCHW in ``torch.channels_last`` memory.

On CUDA the forward is a ``torch.autograd.Function`` whose backward is the
second kernel, gx = M^T g, a gather over the transposed tables of
:func:`transpose_table`.  On the CPU the plain forward is differentiable by
itself, and :func:`resize_backward_plain` spells out the same gradient.

Three routes on the card, chosen from the shape alone (:func:`plan_forward`,
:func:`plan_backward`):

* ``tiled``: a pixel's channels are a whole number of 16-byte vectors
  (C a multiple of 4 in fp32, of 8 in bf16) and both tensors start on a
  16-byte address.  A block owns a tile of the result and a chunk of up to
  ``FORWARD_LANES`` channel vectors (backward: ``BACKWARD_CHANNELS``
  channels); it stages the source span its tables name
  (:func:`forward_spans`, :func:`backward_spans`) in shared memory, blends
  one axis into an fp32 buffer there and the other axis from that buffer.
  The tile starts at ``FORWARD_TILE`` / ``BACKWARD_TILE``, grows while the
  tensor has fewer channels than a block takes (so that a block keeps as
  many vectors to make), and is halved along the axis with the longer span
  until the block's shared memory fits ``SMEM_BUDGET`` (a downsample's
  spans are long).
* ``row``: C = 1, the logits resize, whose NHWC rows are contiguous along
  W; the result's row is a whole number of 16-byte vectors (OW forward, W
  backward: a multiple of 4 in fp32, of 8 in bf16) and both tensors start
  on a 16-byte address.  The same three stages with W in the role the
  channels had.  Forward: a block owns ``ROW_TILE`` output rows x columns,
  stages its source span (the first column rounded down to a vector),
  blends W once per span row into the fp32 buffer, a thread making one
  vector of neighbouring outputs, and H from it with one 16-byte store a
  thread (:func:`row_smem_bytes` mirrors the layout).  Backward: a block
  owns ``ROW_BWD_TILE`` gx rows x vectors of columns, stages the g span
  its lists name, sums H^T once per (gx row, span column) into the fp32
  buffer, a thread making one vector of columns, then W^T from it, a
  thread summing one column's list for four rows at once, rounded into a
  tile that goes out 16 bytes a thread (:func:`row_bwd_smem_bytes`);
  where the block cannot fit the card, the scalar route.
* ``scalar``: every other shape (C = 3, a bf16 C = 4, a result row off a
  vector, a tensor off a 16-byte address) takes the one-element-per-thread
  kernels, which read through the caches.

All routes do the same arithmetic in the same order and give the same bits.
Outside a recorded graph (no grad mode, or an input that does not require
grad) :func:`resize` launches the kernel directly; under autograd it goes
through the Function, and either way the launch's arguments come from a
per-shape cache keyed on cheap values.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from vaeunet_tpu_torch.ops import _ext

_DTYPES = (torch.float32, torch.bfloat16)

VEC_BYTES = 16                 # one thread's load or store
SMEM_LIMIT = 232_448           # shared memory a block can use on sm_90
SMEM_BUDGET = 100 * 1024       # at least two blocks on an SM
# The fastest of the tiles and lanes timed on the H100 at the model's 2x
# upsamples (the optimum is flat: the best five lie within 4 %) and, for the
# row route, at the logits resize: CHANGES.md, the tiled and the row kernel.
FORWARD_TILE = (16, 8)         # output rows x columns of a block
FORWARD_LANES = 16             # 16-byte vectors of a pixel a block takes: 256 bytes
BACKWARD_TILE = (4, 16)        # input rows x columns of a block
BACKWARD_CHANNELS = 32         # channels a block takes: its fp32 buffer is as large in bf16
ROW_TILE = (32, 256)           # the row route: output rows x columns of a block
# the row route's gradient: gx rows x 16-byte vectors of columns of a block (the
# fastest tile timed at the logits' gradient in both types: CHANGES.md, the row
# gradient kernel)
ROW_BWD_TILE = (8, 32)
MAX_BLOCKS = 2 ** 31 - 1       # gridDim.x


def _source_coords(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Source coordinates in float32, matching PyTorch's upsample kernels
    (copy of ``vaeunet_tpu/ops/resize.py::_source_coords``)."""
    if align_corners:
        if out_size == 1:
            return np.zeros((1,), dtype=np.float32)
        scale = np.float32(in_size - 1) / np.float32(out_size - 1)
        return np.arange(out_size, dtype=np.float32) * scale
    scale = np.float32(in_size) / np.float32(out_size)
    coords = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    return np.maximum(coords, np.float32(0.0))


def axis_table(in_size: int, out_size: int, align_corners: bool
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i0, i1, lambda) for one axis: int32, int32, float32 of length
    out_size.  An axis kept at its size gets the identity table."""
    if in_size == out_size:
        k = np.arange(out_size, dtype=np.int32)
        return k, k.copy(), np.zeros(out_size, np.float32)
    coords = _source_coords(in_size, out_size, align_corners)
    i0 = np.clip(np.floor(coords).astype(np.int32), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1).astype(np.int32)
    lam = (coords - i0).astype(np.float32)
    return i0, i1, lam


@functools.lru_cache(maxsize=256)
def _device_table(in_size: int, out_size: int, align_corners: bool, device: str):
    # cached tables outlive the call: never make them inference tensors,
    # which a later training step could not save for backward
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in
                     axis_table(in_size, out_size, align_corners))


def _lerp_axis(x: torch.Tensor, dim: int, out_size: int, align_corners: bool) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    i0, i1, lam = _device_table(in_size, out_size, align_corners, str(x.device))
    shape = [1] * x.dim()
    shape[dim] = out_size
    lam = lam.view(shape)
    lo = x.index_select(dim, i0)
    hi = x.index_select(dim, i1)
    return (1.0 - lam) * lo + lam * hi


def resize_plain(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """W first, then H, in fp32 (the JAX CPU path's order), cast back."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    y = _lerp_axis(x.float(), 3, ow, align_corners)
    y = _lerp_axis(y, 2, oh, align_corners)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def transpose_table(in_size: int, out_size: int, align_corners: bool
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The transpose of one axis's interpolation, in CSR form: (ptr int32
    [in_size + 1], out index int32 [nnz], weight float32 [nnz]).  Input i's
    pairs are ``[ptr[i], ptr[i + 1])``: first those where i is an output's
    i0 (weight 1 - lambda), then those where it is its i1 (weight lambda),
    each in ascending output order -- the order in which the plain
    version's two ``index_add_`` passes add them."""
    i0, i1, lam = axis_table(in_size, out_size, align_corners)
    src = np.concatenate([i0, i1])
    outs = np.tile(np.arange(out_size, dtype=np.int32), 2)
    wts = np.concatenate([np.float32(1.0) - lam, lam]).astype(np.float32)
    order = np.argsort(src, kind="stable")
    ptr = np.zeros(in_size + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=in_size), out=ptr[1:])
    return ptr, outs[order].astype(np.int32), wts[order]


@functools.lru_cache(maxsize=256)
def _device_transpose_table(in_size: int, out_size: int, align_corners: bool, device: str):
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device) for t in
                     transpose_table(in_size, out_size, align_corners))


def _scatter_axis(g: torch.Tensor, dim: int, in_size: int, align_corners: bool) -> torch.Tensor:
    """The transpose of :func:`_lerp_axis` along `dim`."""
    out_size = g.shape[dim]
    if in_size == out_size:
        return g
    i0, i1, lam = _device_table(in_size, out_size, align_corners, str(g.device))
    shape = [1] * g.dim()
    shape[dim] = out_size
    lam = lam.view(shape)
    out_shape = list(g.shape)
    out_shape[dim] = in_size
    out = g.new_zeros(out_shape)
    out.index_add_(dim, i0, (1.0 - lam) * g)
    out.index_add_(dim, i1, lam * g)
    return out


def resize_backward_plain(g: torch.Tensor, in_hw: Tuple[int, int],
                          align_corners: bool) -> torch.Tensor:
    """gx = M^T g of :func:`resize_plain`, in fp32, cast back to g's dtype.

    The reverse of the forward's order: H^T first, then W^T, each as two
    ``index_add_`` passes (the i0 pairs, then the i1 pairs).  On the CPU
    ``index_add_`` adds in index order, the order the kernel sums in, so the
    two agree bit for bit; on CUDA ``index_add_`` adds with atomics in no
    fixed order, and the two agree to fp32 rounding (the tolerance in
    ``chip_smoke.py`` is 1e-6 of the sum of the terms' magnitudes)."""
    t = _scatter_axis(g.float(), 2, int(in_hw[0]), align_corners)
    gx = _scatter_axis(t, 3, int(in_hw[1]), align_corners)
    return gx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def forward_spans(i0: np.ndarray, i1: np.ndarray, tile: int) -> np.ndarray:
    """For each run of `tile` outputs of one axis, the inputs its table
    entries name: int32 [tiles, 2] of (first input, count).  The tables are
    monotone, so the span first .. first + count - 1 holds no more than the
    tile reads, apart from an edge the clamp doubles."""
    n = -(-len(i0) // tile)
    out = np.zeros((n, 2), np.int32)
    for t in range(n):
        lo = int(i0[t * tile:(t + 1) * tile].min())
        hi = int(i1[t * tile:(t + 1) * tile].max())
        out[t] = (lo, hi - lo + 1)
    return out


def backward_spans(ptr: np.ndarray, idx: np.ndarray, tile: int) -> Tuple[np.ndarray, int]:
    """For each run of `tile` inputs of one axis, the outputs whose pairs
    (``transpose_table``) name one of them: int32 [tiles, 2] of (first
    output, count), (0, 0) where no output reads the run (a downsample);
    and the most pairs a run has."""
    in_size = len(ptr) - 1
    n = -(-in_size // tile)
    out = np.zeros((n, 2), np.int32)
    nnz = 0
    for t in range(n):
        seg = idx[ptr[t * tile]:ptr[min((t + 1) * tile, in_size)]]
        nnz = max(nnz, len(seg))
        if len(seg):
            out[t] = (seg.min(), seg.max() - seg.min() + 1)
    return out, nnz


class TilePlan(NamedTuple):
    """How one resize (or its gradient) runs on the card."""
    route: str          # "tiled", "row" or "scalar"
    tile_h: int = 0     # rows and columns of the result a block owns (powers of two)
    tile_w: int = 0
    lanes: int = 0      # 16-byte channel vectors of a pixel a block takes (a power of two); row: 0
    chunks: int = 0     # blocks along the channels: ceil(vectors / lanes)
    span_h: int = 0     # the longest source span of a tile, rows and columns
    span_w: int = 0
    nnz_h: int = 0      # backward: the most pairs a tile's rows / columns have
    nnz_w: int = 0
    smem_bytes: int = 0
    blocks: int = 0


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def tiled_smem_bytes(backward: bool, tile_h: int, tile_w: int, lanes: int, span_h: int,
                     span_w: int, nnz_h: int, nnz_w: int, elem_size: int) -> int:
    """Shared memory of one block, as ``csrc/resize.cu`` lays it out: the
    tile's tables, the staged span in the tensor's type, and the fp32
    buffer of the first blend (W forward, H^T backward)."""
    planes = VEC_BYTES // elem_size // 4          # fp32 vectors per staged vector
    if backward:
        tables = _round16(4 * (tile_h + 1 + tile_w + 1 + 2 * (nnz_h + nnz_w)))
        inner = tile_h * span_w
    else:
        tables = _round16(12 * (tile_h + tile_w))
        inner = span_h * tile_w
    return tables + VEC_BYTES * lanes * (span_h * span_w + planes * inner)


def row_pitch(span_w: int, elem_size: int) -> int:
    """Elements of one staged row of the row route: the span, after its
    first column is rounded down to a 16-byte vector and its end up."""
    vec = VEC_BYTES // elem_size
    return -(-(span_w + vec - 1) // vec) * vec


def row_smem_bytes(tile_h: int, tile_w: int, span_h: int, span_w: int, elem_size: int) -> int:
    """Shared memory of one block of the row route, as ``csrc/resize.cu``
    lays it out: the tile's tables (`tile_w` counts columns), the staged
    span in the tensor's type, and the fp32 buffer of the W blend."""
    tables = _round16(12 * (tile_h + tile_w))
    return (tables + _round16(span_h * row_pitch(span_w, elem_size) * elem_size)
            + 4 * span_h * tile_w)


def row_bwd_smem_bytes(tile_h: int, tile_w: int, span_h: int, span_w: int, nnz_h: int,
                       nnz_w: int, elem_size: int) -> int:
    """Shared memory of one block of the row route's gradient, as
    ``csrc/resize.cu`` lays it out: the tile's lists, the staged span of g
    in the tensor's type, the fp32 buffer of the H^T sums (the span's
    columns for each of the tile's rows), and the tile's gx, rounded, for
    the 16-byte stores."""
    tables = _round16(4 * (tile_h + 1 + tile_w + 1 + 2 * (nnz_h + nnz_w)))
    pitch = row_pitch(span_w, elem_size)
    return (tables + _round16(span_h * pitch * elem_size) + 4 * tile_h * pitch
            + tile_h * tile_w * elem_size)


def _plan_row(in_hw: Tuple[int, int], out_hw: Tuple[int, int], elem_size: int,
              align_corners: bool, batch: int, tile: Optional[Tuple[int, int]]) -> TilePlan:
    """The row route's tile: ``ROW_TILE`` (or `tile`) capped by the output,
    its columns a power of two of vectors, halved along the longer span
    until the block fits the budget."""
    vec = VEC_BYTES // elem_size
    fixed = tile is not None
    t = list(tile if fixed else ROW_TILE)
    if not fixed:
        t = [min(t[0], _pow2_at_least(out_hw[0])),
             max(vec, min(t[1], vec * _pow2_at_least(out_hw[1] // vec)))]

    def sized(t):
        sh = _axis_spans(False, in_hw[0], out_hw[0], align_corners, t[0])[0]
        sw = _axis_spans(False, in_hw[1], out_hw[1], align_corners, t[1])[0]
        span = (int(sh[:, 1].max()), int(sw[:, 1].max()))
        return span, row_smem_bytes(t[0], t[1], *span, elem_size)

    span, smem = sized(t)
    while not fixed and smem > SMEM_BUDGET and t != [1, vec]:
        shrink = 0 if (span[0] >= span[1] and t[0] > 1) or t[1] == vec else 1
        t[shrink] //= 2
        span, smem = sized(t)
    if smem > SMEM_LIMIT:
        raise ValueError(f"resize: a {t[0]}x{t[1]} row tile needs {smem} bytes of shared "
                         f"memory, over the card's {SMEM_LIMIT}")
    blocks = -(-out_hw[0] // t[0]) * -(-out_hw[1] // t[1]) * batch
    if blocks > MAX_BLOCKS:
        raise ValueError(f"resize: {blocks} blocks exceed the grid's {MAX_BLOCKS}")
    return TilePlan("row", t[0], t[1], 0, 1, span[0], span[1], 0, 0, smem, blocks)


def _plan_row_bwd(in_hw: Tuple[int, int], out_hw: Tuple[int, int], elem_size: int,
                  align_corners: bool, batch: int, tile: Optional[Tuple[int, int]]) -> TilePlan:
    """The row route's gradient: gx's tile ``ROW_BWD_TILE`` (or `tile`, in
    rows x columns) capped by gx, its columns a power of two of vectors,
    halved along the longer span of g until the block fits the budget.
    Where even one row of one vector does not fit the card, the scalar
    route (a `tile` given raises instead)."""
    vec = VEC_BYTES // elem_size
    fixed = tile is not None
    t = list(tile if fixed else ROW_BWD_TILE)
    if not fixed:
        t = [min(t[0], _pow2_at_least(in_hw[0])),
             vec * min(t[1], _pow2_at_least(in_hw[1] // vec))]

    def sized(t):
        sh, nh = _axis_spans(True, in_hw[0], out_hw[0], align_corners, t[0])
        sw, nw = _axis_spans(True, in_hw[1], out_hw[1], align_corners, t[1])
        span = (int(sh[:, 1].max()), int(sw[:, 1].max()))
        return span, (nh, nw), row_bwd_smem_bytes(t[0], t[1], *span, nh, nw, elem_size)

    span, nnz, smem = sized(t)
    while not fixed and smem > SMEM_BUDGET and t != [1, vec]:
        shrink = 0 if (span[0] >= span[1] and t[0] > 1) or t[1] == vec else 1
        t[shrink] //= 2
        span, nnz, smem = sized(t)
    blocks = -(-in_hw[0] // t[0]) * -(-in_hw[1] // t[1]) * batch
    if smem > SMEM_LIMIT or blocks > MAX_BLOCKS:
        if not fixed:
            return TilePlan("scalar")
        raise ValueError(f"resize: a {t[0]}x{t[1]} row tile of the gradient needs {smem} bytes "
                         f"of shared memory and {blocks} blocks, over the card's "
                         f"{SMEM_LIMIT} and {MAX_BLOCKS}")
    return TilePlan("row", t[0], t[1], 0, 1, span[0], span[1], nnz[0], nnz[1], smem, blocks)


def _axis_spans(backward: bool, in_size: int, out_size: int, align_corners: bool, tile: int):
    if backward:
        ptr, idx, _ = transpose_table(in_size, out_size, align_corners)
        return backward_spans(ptr, idx, tile)
    i0, i1, _ = axis_table(in_size, out_size, align_corners)
    return forward_spans(i0, i1, tile), 0


@functools.lru_cache(maxsize=512)
def _plan(backward: bool, in_hw: Tuple[int, int], out_hw: Tuple[int, int], channels: int,
          elem_size: int, align_corners: bool, batch: int,
          tile: Optional[Tuple[int, int]], lanes: Optional[int]) -> TilePlan:
    if channels == 1 and ((in_hw if backward else out_hw)[1] * elem_size) % VEC_BYTES == 0:
        planner = _plan_row_bwd if backward else _plan_row
        return planner(in_hw, out_hw, elem_size, align_corners, batch, tile)
    if (channels * elem_size) % VEC_BYTES:
        return TilePlan("scalar")
    vecs = channels * elem_size // VEC_BYTES
    most = BACKWARD_CHANNELS * elem_size // VEC_BYTES if backward else FORWARD_LANES
    lanes = min(most, _pow2_at_least(vecs)) if lanes is None else lanes
    own_hw = in_hw if backward else out_hw             # the result a block tiles
    cap = [_pow2_at_least(own_hw[0]), _pow2_at_least(own_hw[1])]
    fixed = tile is not None
    t = list(tile if fixed else (BACKWARD_TILE if backward else FORWARD_TILE))
    target = t[0] * t[1] * most
    t = [min(t[0], cap[0]), min(t[1], cap[1])]
    while not fixed and t[0] * t[1] * lanes < target and t != cap:
        grow = 1 if (t[1] <= t[0] and t[1] < cap[1]) or t[0] == cap[0] else 0
        t[grow] *= 2

    def sized(t):
        sh, nh = _axis_spans(backward, in_hw[0], out_hw[0], align_corners, t[0])
        sw, nw = _axis_spans(backward, in_hw[1], out_hw[1], align_corners, t[1])
        span = (int(sh[:, 1].max()), int(sw[:, 1].max()))
        return span, (nh, nw), tiled_smem_bytes(backward, t[0], t[1], lanes, *span, nh, nw,
                                                elem_size)

    span, nnz, smem = sized(t)
    while not fixed and smem > SMEM_BUDGET and t != [1, 1]:
        shrink = 0 if (span[0] >= span[1] and t[0] > 1) or t[1] == 1 else 1
        t[shrink] //= 2
        span, nnz, smem = sized(t)
    if smem > SMEM_LIMIT:
        raise ValueError(f"resize: a {t[0]}x{t[1]} tile of {lanes} lanes needs {smem} bytes of "
                         f"shared memory, over the card's {SMEM_LIMIT}")
    chunks = -(-vecs // lanes)
    blocks = chunks * -(-own_hw[0] // t[0]) * -(-own_hw[1] // t[1]) * batch
    if blocks > MAX_BLOCKS:
        raise ValueError(f"resize: {blocks} blocks exceed the grid's {MAX_BLOCKS}")
    return TilePlan("tiled", t[0], t[1], lanes, chunks, span[0], span[1], nnz[0], nnz[1],
                    smem, blocks)


def plan_forward(in_hw: Tuple[int, int], out_hw: Tuple[int, int], channels: int, elem_size: int,
                 align_corners: bool, batch: int = 1, tile: Optional[Tuple[int, int]] = None,
                 lanes: Optional[int] = None) -> TilePlan:
    """The route and tile of ``resize`` for x [batch, channels, *in_hw] of
    `elem_size` bytes an element.  `tile` (output rows, columns; powers of
    two; on the row route the columns are a power of two of vectors) and
    `lanes` fix what the rule would choose (for tuning)."""
    return _plan(False, tuple(in_hw), tuple(out_hw), channels, elem_size, bool(align_corners),
                 batch, tile, lanes)


def plan_backward(in_hw: Tuple[int, int], out_hw: Tuple[int, int], channels: int,
                  elem_size: int, align_corners: bool, batch: int = 1,
                  tile: Optional[Tuple[int, int]] = None,
                  lanes: Optional[int] = None) -> TilePlan:
    """The route and tile of ``resize_backward`` for g [batch, channels,
    *out_hw]; the tile is of gx rows and columns."""
    return _plan(True, tuple(in_hw), tuple(out_hw), channels, elem_size, bool(align_corners),
                 batch, tile, lanes)


@functools.lru_cache(maxsize=256)
def _device_spans(backward: bool, in_size: int, out_size: int, align_corners: bool, tile: int,
                  device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_axis_spans(backward, in_size, out_size, align_corners,
                                            tile)[0]).to(device)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"resize expects NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resize takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("resize expects a channels_last-contiguous tensor")


def _launch_setup(backward: bool, shape: Tuple[int, int, int, int], out_hw: Tuple[int, int],
                  align_corners: bool, dtype: torch.dtype, device: torch.device, scalar: bool,
                  plan: Optional[TilePlan]):
    """Everything of a launch that the shape decides: -> (the C entry's
    name, the arguments after the two tensors, the device tables those
    point into, kept alive with this entry).  `shape` is the resize's input
    [B, C, H, W] (backward: gx's), `out_hw` its output's (backward: g's)."""
    b, c, h, w = shape
    oh, ow = out_hw
    elem_size = 4 if dtype == torch.float32 else 2
    if plan is None:
        plan = _plan(backward, (h, w), (oh, ow), c, elem_size, align_corners, b, None, None)
    if scalar:
        plan = TilePlan("scalar")
    dev = str(device)
    table = _device_transpose_table if backward else _device_table
    keep = [*table(h, oh, align_corners, dev), *table(w, ow, align_corners, dev)]
    name = "vaeunet_resize_bwd" if backward else "vaeunet_resize"
    tail: Tuple[int, ...] = ()
    if plan.route == "scalar":
        name += "_scalar"
    else:
        keep += [_device_spans(backward, h, oh, align_corners, plan.tile_h, dev),
                 _device_spans(backward, w, ow, align_corners, plan.tile_w, dev)]
        if plan.route == "row":
            name = "vaeunet_resize_row_bwd" if backward else "vaeunet_resize_row"
            vec = VEC_BYTES // elem_size
            tail = (plan.tile_h.bit_length() - 1, (plan.tile_w // vec).bit_length() - 1,
                    row_pitch(plan.span_w, elem_size))
            if backward:
                tail += (plan.nnz_h, plan.nnz_w)
        else:
            tail = (plan.tile_h.bit_length() - 1, plan.tile_w.bit_length() - 1,
                    plan.lanes.bit_length() - 1)
            if backward:
                tail += (plan.nnz_h, plan.nnz_w)
        tail += (plan.smem_bytes,)
    name += "_f32" if dtype == torch.float32 else "_bf16"
    return name, (*(t.data_ptr() for t in keep), b, h, w, c, oh, ow, *tail), keep


# launch key -> _launch_setup's result.  The key is made of values a call
# has at hand (sizes, the dtype, the device's index): the lookup is on every
# launch's path.
_SETUPS: dict = {}
_SETUPS_MOST = 1024


def launch_args(src: torch.Tensor, dst: torch.Tensor, align_corners: bool,
                backward: bool = False, plan: Optional[TilePlan] = None, scalar: bool = False):
    """(C entry, arguments) of one launch from `src` into `dst`, both
    channels_last: x into y, or with `backward` g into gx.  The tiled and
    row routes also need both on 16-byte addresses.  `plan` fixes a plan and
    `scalar` the scalar route (for tuning and for holding one against the
    other)."""
    src_ptr, dst_ptr = src.data_ptr(), dst.data_ptr()
    device = src.device
    key = (backward, src.shape, dst.shape, align_corners, src.dtype, device.index,
           scalar or (src_ptr | dst_ptr) % VEC_BYTES != 0, plan)
    hit = _SETUPS.get(key)
    if hit is None:
        if len(_SETUPS) >= _SETUPS_MOST:
            _SETUPS.clear()
        shape, out_hw = (dst.shape, src.shape[2:]) if backward else (src.shape, dst.shape[2:])
        hit = _SETUPS[key] = _launch_setup(backward, tuple(shape), tuple(out_hw),
                                           bool(align_corners), src.dtype, device, key[6], plan)
    return hit[0], (src_ptr, dst_ptr, *hit[1])


def _resize_cuda(x: torch.Tensor, oh: int, ow: int, align_corners: bool) -> torch.Tensor:
    y = torch.empty((x.shape[0], x.shape[1], oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    fn, args = launch_args(x, y, align_corners)
    _ext.call("resize", fn, x.device, *args)
    _ext.count_launch("resize")
    if "_row_" in fn:
        _ext.count_launch("resize_row")
    return y


def resize_backward(g: torch.Tensor, in_hw: Tuple[int, int],
                    align_corners: bool) -> torch.Tensor:
    """Gradient of :func:`resize` with respect to its input: gx [B, C, H, W]
    channels_last from g [B, C, OH, OW] (any memory layout; it is made
    channels_last here, as autograd may hand over an NCHW-contiguous g)."""
    if g.dim() != 4:
        raise ValueError(f"resize_backward expects NCHW, got shape {tuple(g.shape)}")
    g = g.contiguous(memory_format=torch.channels_last)
    _check(g)
    if g.device.type == "cpu":
        return resize_backward_plain(g, in_hw, align_corners)
    if g.device.type != "cuda":
        raise ValueError(f"resize_backward: unsupported device {g.device}")
    gx = torch.empty((g.shape[0], g.shape[1], int(in_hw[0]), int(in_hw[1])), dtype=g.dtype,
                     device=g.device, memory_format=torch.channels_last)
    if gx.numel() == 0:
        return gx
    fn, args = launch_args(g, gx, align_corners, backward=True)
    _ext.call("resize", fn, g.device, *args)
    _ext.count_launch("resize_bwd")
    if "_row_" in fn:
        _ext.count_launch("resize_bwd_row")
    return gx


class _ResizeCuda(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, oh, ow, align_corners):
        ctx.in_hw = (x.shape[2], x.shape[3])
        ctx.align_corners = align_corners
        return _resize_cuda(x, oh, ow, align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return resize_backward(g, ctx.in_hw, ctx.align_corners), None, None, None


def _launch_or_record(x: torch.Tensor, oh: int, ow: int, align_corners: bool) -> torch.Tensor:
    """The kernel's launch alone where no graph is being recorded (the
    serving path, an eval step); else through the Function, whose host work
    is several times the launch's."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResizeCuda.apply(x, oh, ow, align_corners)
    return _resize_cuda(x, oh, ow, align_corners)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool) -> torch.Tensor:
    """Bilinear resize of a channels_last NCHW tensor to `out_hw`;
    differentiable with respect to `x` on both devices.  On the card the
    kernel is launched directly where no graph is being recorded, and
    through the autograd Function (the backward kernel as its gradient)
    where one is."""
    _check(x)
    b, c, h, w = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    if x.device.type == "cpu":
        return resize_plain(x, (oh, ow), align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"resize: unsupported device {x.device}")
    return _launch_or_record(x, oh, ow, align_corners)


def resize_h(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along H only (the JAX ``resize_h``): W keeps its size."""
    return resize(x, (out_size, x.shape[3]), align_corners)


def resize_w(x: torch.Tensor, out_size: int, align_corners: bool = True) -> torch.Tensor:
    """Resize along W only (the JAX ``resize_w``): H keeps its size."""
    return resize(x, (x.shape[2], out_size), align_corners)
