"""The eval BN + ReLU kernel's plan, on the CPU: which route, vector width,
block and grid :func:`bn_relu.plan` gives each shape; a numpy model of the
kernel's thread mapping (``csrc/bn_relu.cu``) showing that every element is
written exactly once with its own channel's (a, b); the launch arguments
against the C entry; and the constants the source shares with the wrapper.
The kernel itself runs only on the card (``tests/test_torch_cuda_kernels2.py``).
Inputs come from numpy seeds."""

import re

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu

SOURCE = (_ext.CSRC / "bn_relu.cu").read_text()
CHANNELS = [6, 12, 32, 64, 512, 1024, 2048]


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_route_width_block_and_grid(c, elem, aligned):
    """Vector route exactly where both tensors are on 16-byte addresses and
    a pixel is whole 16-byte vectors; the block holds at most 256 threads,
    its x the pixel's vectors (the rest in chunks along y of the grid) and
    its y as many rows as fill it; the grid covers the rows once."""
    rows = 8 * 37 * 29
    p = bn_relu.plan(rows, c, elem, aligned)
    vec = 16 // elem
    vector = aligned and c % vec == 0
    assert p.route == ("vector" if vector else "scalar")
    assert p.vec == (vec if vector else 1)
    vecs = c // p.vec
    bx, by = p.block
    gx, gy = p.grid
    assert bx == min(vecs, 256) and by == 256 // bx and bx * by <= 256
    assert bx * gy >= vecs > bx * (gy - 1)                  # the chunks cover C, none idle
    per_block = by * bn_relu.ROWS_IN_FLIGHT
    assert gx * per_block >= rows > (gx - 1) * per_block    # sized for the tensor, not capped


@pytest.mark.parametrize("rows,c,elem,aligned,want", [
    (8 * 256 * 256, 64, 4, True, ("vector", 4, (16, 16), (8192, 1))),   # [8,64,256,256]
    (8 * 256 * 256, 64, 2, True, ("vector", 8, (8, 32), (4096, 1))),
    (8 * 256 * 256, 32, 4, True, ("vector", 4, (8, 32), (4096, 1))),    # z_proj
    (16 * 16 * 16, 2048, 4, True, ("vector", 4, (256, 1), (1024, 2))),  # resnet50: 2 chunks
    (16 * 16 * 16, 2048, 2, True, ("vector", 8, (256, 1), (1024, 1))),
    (89 * 134, 1024, 4, True, ("vector", 4, (256, 1), (2982, 1))),      # the UNet's bottom
    (8 * 256 * 256, 64, 4, False, ("scalar", 1, (64, 4), (32768, 1))),  # off a 16-byte address
    (8 * 256 * 256, 6, 2, True, ("scalar", 1, (6, 42), (3121, 1))),     # ragged C
    (8 * 256 * 256, 12, 2, True, ("scalar", 1, (12, 21), (6242, 1)))])
def test_plan_at_the_path_shapes(rows, c, elem, aligned, want):
    assert tuple(bn_relu.plan(rows, c, elem, aligned)) == want


def kernel_model(rows: int, c: int, p: bn_relu.Plan, grid_x: int = None):
    """For each element of a [rows, c] tensor: how many threads wrote it,
    and the channel whose (a, b) the writing thread folded.  Walks blocks,
    threads and the row loop as bn_relu_kernel does."""
    writes = np.zeros(rows * c, np.int64)
    channel = np.full(rows * c, -1, np.int64)
    vecs = c // p.vec
    (bx, by), (gx, gy) = p.block, p.grid
    gx = gx if grid_x is None else grid_x
    u = bn_relu.ROWS_IN_FLIGHT
    tx, ty = np.meshgrid(np.arange(bx), np.arange(by), indexing="ij")
    tx, ty = tx.ravel(), ty.ravel()
    for block_y in range(gy):
        v = block_y * bx + tx
        live = v < vecs                                       # `if (v >= vecs) return;`
        for block_x in range(gx):
            r0 = block_x * by * u + ty
            while True:
                active = live & (r0 < rows)
                if not active.any():
                    break
                for k in range(u):
                    r = r0 + k * by
                    ok = active & (r < rows)
                    for j in range(p.vec):
                        ch = v[ok] * p.vec + j
                        idx = r[ok] * c + ch                  # x[r * vecs + v], lane j
                        np.add.at(writes, idx, 1)
                        channel[idx] = ch
                r0 = r0 + gx * by * u                         # the grid-stride step
    return writes, channel


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_every_element_is_written_once_with_its_channel(c, elem, aligned):
    rows = 2 * 5 * 7 + 3 if c < 512 else 9        # ragged against a block's rows
    p = bn_relu.plan(rows, c, elem, aligned)
    writes, channel = kernel_model(rows, c, p)
    assert (writes == 1).all()
    assert (channel == np.tile(np.arange(c), rows)).all()


def test_the_grid_stride_loop_covers_what_a_short_grid_leaves():
    """Where the grid cannot hold the tensor (2^31 - 1 blocks), the row
    loop walks on: the model with a grid of one and of two blocks."""
    rows = 4 * 16 * 4 + 5
    p = bn_relu.plan(rows, 64, 4, True)
    for grid_x in (1, 2):
        writes, channel = kernel_model(rows, 64, p, grid_x=grid_x)
        assert (writes == 1).all() and (channel == np.tile(np.arange(64), rows)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_mapping_applies_each_channels_fold(dtype):
    """y from the mapping, each product and sum rounded in fp32 and rounded
    once to the type, equals the plain version bit for bit on the same
    (a, b): a thread's registers hold its own channels' fold."""
    rng = np.random.RandomState(0)
    n, c, h, w = 2, 24, 3, 5
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).to(dtype)   # NHWC
    a = rng.rand(c).astype(np.float32) + 0.5
    b = rng.randn(c).astype(np.float32)
    rows = n * h * w
    p = bn_relu.plan(rows, c, x.element_size(), True)
    assert p.route == "vector"
    _, channel = kernel_model(rows, c, p)
    flat = x.float().numpy().reshape(-1)
    y = np.maximum(flat * a[channel] + b[channel], np.float32(0)).astype(np.float32)
    ours = torch.from_numpy(y.reshape(n, h, w, c)).to(dtype).permute(0, 3, 1, 2)
    ref = bn_relu.fused_bn_relu_plain(x.permute(0, 3, 1, 2), torch.from_numpy(a),
                                      torch.from_numpy(b))
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [False, True])
def test_launch_arguments_fit_the_c_entry(dtype, offset):
    """x, y, the four statistics as given (no fold on the host), eps, the
    rows and C, then the plan; the stream is appended by ``_ext.call``."""
    c = 64
    base = torch.zeros(2 * 3 * 5 * c + 1, dtype=dtype)
    x = base[int(offset):int(offset) + 2 * 3 * 5 * c].view(2, 3, 5, c).permute(0, 3, 1, 2)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = [torch.full((c,), float(i)) for i in range(4)]
    fn, args = bn_relu.launch_args(x, y, *stats, 1e-3)
    assert fn == f"vaeunet_bn_relu_{'f32' if dtype == torch.float32 else 'bf16'}"
    assert len(args) + 1 == len(_ext.SIGNATURES["bn_relu"][fn])
    assert args[:6] == (x.data_ptr(), y.data_ptr(), *(s.data_ptr() for s in stats))
    assert args[6] == 1e-3 and args[7:9] == (30, c)
    p = bn_relu.plan(30, c, x.element_size(), (x.data_ptr() | y.data_ptr()) % 16 == 0)
    assert args[9:] == (p.vec, *p.block, *p.grid)
    assert p.route == ("scalar" if offset else "vector")


def test_source_constants_match_the_wrapper():
    assert int(re.search(r"constexpr int kThreads = (\d+);", SOURCE)[1]) == bn_relu.THREADS
    assert (int(re.search(r"constexpr int kRowsInFlight = (\d+);", SOURCE)[1])
            == bn_relu.ROWS_IN_FLIGHT)


def test_cpu_path_folds_on_the_host_and_checks_the_fold():
    """On the CPU the statistics are folded by ``fold`` (any float type) and
    the plain version runs; a wrong length still raises."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 8, 3, 3).astype(np.float32)).contiguous(
        memory_format=torch.channels_last)
    stats = [torch.from_numpy(rng.rand(8) + 0.5) for _ in range(4)]          # float64
    y = bn_relu.fused_bn_relu(x, *stats)
    assert torch.equal(y, bn_relu.fused_bn_relu_plain(x, *bn_relu.fold(*stats)))
    with pytest.raises(ValueError, match="float32"):
        bn_relu.fused_bn_relu(x, *[s[:4] for s in stats])
