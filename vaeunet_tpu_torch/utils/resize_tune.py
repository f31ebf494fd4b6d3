"""Time the tiled and row resize kernels over tiles and lanes on the card.

    python -m vaeunet_tpu_torch.utils.resize_tune [--quick] [--row] [--row-bwd]

New in the port: the numbers behind the tile rule of
``ops/pallas/resize_mm.py`` (``FORWARD_TILE``, ``FORWARD_LANES``,
``BACKWARD_TILE``, ``BACKWARD_CHANNELS``).  For the 2x upsamples of the serving request (fp32, batch 8)
and of the training step (bf16 and fp32, batch 16), forward and backward, it
launches the tiled kernel with every candidate (tile rows x columns, lanes)
that fits the card's shared memory, holds each result bit for bit against
the rule's own plan, and prints the launch's device time (CUDA events, the
launch alone on prepared tensors) beside the one-element-per-thread kernel's
and the bytes bound.  For the logits resize (C = 1, 256^2 -> 512^2) it
sweeps the row route's tile (output rows x columns) the same way, beside
the scalar kernel and ``F.interpolate``; ``--row`` runs only that sweep.
``--row-bwd`` sweeps the row route's gradient at the same resize (gx rows x
columns, ``ROW_BWD_TILE``), each tile's device time from a CUDA graph,
beside the scalar kernel and ``upsample_bilinear2d_backward``, and runs
only that.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import time

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import resize_mm

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
# (channels, input H = W) of the decoder's four 2x upsamples
LAYERS = ((512, 16), (512, 32), (256, 64), (128, 128))
FORWARD_TILES = ((8, 16), (16, 8), (16, 16), (8, 8), (16, 4), (32, 4), (32, 8), (8, 32),
                 (16, 32), (32, 16), (32, 32))
BACKWARD_TILES = ((4, 8), (8, 4), (8, 8), (2, 8), (2, 16), (2, 32), (4, 4), (4, 16), (4, 32),
                  (8, 16), (16, 8), (16, 16))
LANES = (2, 4, 8, 16, 32)
ROW_TILES = tuple(itertools.product((2, 4, 8, 16, 32), (32, 64, 128, 256, 512)))
ROW_BWD_TILES = tuple(itertools.product((1, 2, 4, 8, 16, 32), (32, 64, 128, 256)))
# (batch, type) of the logits resize: the request's, the bf16 step's, the fp32 step's
ROW_CASES = ((8, torch.float32), (16, torch.bfloat16), (16, torch.float32))


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Device time of one fn(): `launches` of them captured in a CUDA graph
    and replayed, so that no host work sits between two launches (at a few
    microseconds a kernel the host cannot enqueue as fast as the card runs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, replays) / launches


def host_us(fn, iters: int = 3000) -> float:
    """Host time of one fn() in microseconds: the host clock over `iters`
    calls that the device keeps up with (a synchronise before and after)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def launcher(src, dst, backward: bool, plan=None, scalar: bool = False):
    fn, args = resize_mm.launch_args(src, dst, True, backward=backward, plan=plan, scalar=scalar)
    return lambda: _ext.call("resize", fn, src.device, *args)


def sweep(batch: int, dtype: torch.dtype, channels: int, size: int, backward: bool,
          quick: bool) -> None:
    g = torch.Generator(device="cuda").manual_seed(size)
    small = (batch, channels, size, size)
    large = (batch, channels, 2 * size, 2 * size)
    src = torch.randn(large if backward else small, device="cuda", generator=g).to(
        dtype).contiguous(memory_format=torch.channels_last)
    dst = torch.empty(small if backward else large, device="cuda", dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    nbytes = (src.numel() + dst.numel()) * src.element_size()
    iters = int(min(200, max(20, 2e9 / nbytes)))
    planner = resize_mm.plan_backward if backward else resize_mm.plan_forward
    hw = ((size, size), (2 * size, 2 * size))
    rule = planner(*hw, channels, src.element_size(), True, batch)
    launcher(src, dst, backward)()
    want = dst.clone()
    rows = [("scalar", time_ms(launcher(src, dst, backward, scalar=True), iters), 0)]
    check(torch.equal(dst, want), "the scalar kernel differs from the rule's plan")
    tiles = BACKWARD_TILES if backward else FORWARD_TILES
    if quick:
        tiles = ((rule.tile_h, rule.tile_w),)
    for tile, lanes in itertools.product(tiles, LANES):
        if lanes * 16 > channels * src.element_size():
            continue
        try:
            plan = planner(*hw, channels, src.element_size(), True, batch, tile, lanes)
        except ValueError:      # over the card's shared memory
            continue
        dst.zero_()
        fn = launcher(src, dst, backward, plan)
        fn()
        check(torch.equal(dst, want), f"tile {tile} lanes {lanes} differs from the rule's plan")
        mark = " <- rule" if plan[:4] == rule[:4] else ""
        rows.append((f"{tile[0]}x{tile[1]} l{lanes}{mark}", time_ms(fn, iters), plan.smem_bytes))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    what = "bwd" if backward else "fwd"
    print(f"{what} {str(dtype)[6:]} {list(small)}{'<-' if backward else '->'}{2 * size}^2: "
          f"{nbytes / 1e6:.1f} MB, bound {bound:.4f} ms")
    best = min(r[1] for r in rows)
    for name, ms, smem in rows:
        print(f"    {name:22s} {ms:8.4f} ms  {nbytes / ms / 1e9:6.3f} TB/s  smem {smem:6d}"
              f"{'  *' if ms == best else ''}")


def sweep_row(batch: int, dtype: torch.dtype, size: int, quick: bool) -> None:
    """The row route's tiles at x [batch, 1, size, size] -> (2 size)^2."""
    g = torch.Generator(device="cuda").manual_seed(size)
    x = torch.randn((batch, 1, size, size), device="cuda", generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    y = torch.empty((batch, 1, 2 * size, 2 * size), device="cuda", dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    nbytes = (x.numel() + y.numel()) * x.element_size()
    hw = ((size, size), (2 * size, 2 * size))
    rule = resize_mm.plan_forward(*hw, 1, x.element_size(), True, batch)
    check(rule.route == "row", f"the rule sends C = 1 to {rule.route}")
    launcher(x, y, False)()
    want = y.clone()
    iters = 500

    def library():
        return F.interpolate(x, size=hw[1], mode="bilinear", align_corners=True)
    rows = [("scalar", time_ms(launcher(x, y, False, scalar=True), iters), 0)]
    check(torch.equal(y, want), "the scalar kernel differs from the rule's plan")
    rows.append(("F.interpolate", time_ms(library, iters), 0))
    on_device = {"scalar": device_ms(launcher(x, y, False, scalar=True)),
                 "F.interpolate": device_ms(library),
                 "row, the rule's tile": device_ms(launcher(x, y, False))}
    vec = 16 // x.element_size()
    for tile in ((rule.tile_h, rule.tile_w),) if quick else ROW_TILES:
        if tile[1] < vec:
            continue
        try:
            plan = resize_mm.plan_forward(*hw, 1, x.element_size(), True, batch, tile)
        except ValueError:      # over the card's shared memory
            continue
        y.zero_()
        fn = launcher(x, y, False, plan)
        fn()
        check(torch.equal(y, want), f"row tile {tile} differs from the rule's plan")
        mark = " <- rule" if plan[:3] == rule[:3] else ""
        rows.append((f"row {tile[0]}x{tile[1]}{mark}", time_ms(fn, iters), plan.smem_bytes))
    print(f"fwd {str(dtype)[6:]} {list(x.shape)}->{2 * size}^2: {nbytes / 1e6:.1f} MB, "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    best = min(r[1] for r in rows[2:])
    for name, ms, smem in rows:
        print(f"    {name:22s} {ms:8.4f} ms  {nbytes / ms / 1e9:6.3f} TB/s  smem {smem:6d}"
              f"{'  *' if ms == best else ''}")
    print("    on the device alone (a CUDA graph of 50 launches, replayed): "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in on_device.items()))
    # what one wrapped call costs the host, piece by piece
    leaf = x.clone().requires_grad_()
    parts = {"resize()": lambda: resize_mm.resize(x, hw[1], True),
             "resize() recording a graph": lambda: resize_mm.resize(leaf, hw[1], True),
             "torch.empty of y": lambda: torch.empty(y.shape, dtype=dtype, device=x.device,
                                                     memory_format=torch.channels_last),
             "launch_args": lambda: resize_mm.launch_args(x, y, True),
             "_ext.call": launcher(x, y, False),
             "F.interpolate": library}
    print("    host time of one call: "
          + "  ".join(f"{k} {host_us(fn):.1f} us" for k, fn in parts.items()))


def sweep_row_bwd(batch: int, dtype: torch.dtype, size: int, quick: bool) -> None:
    """The row route's gradient tiles at g [batch, 1, 2 size, 2 size] ->
    gx [batch, 1, size, size], align_corners=True (the logits' gradient);
    each tile held bit for bit against the scalar kernel."""
    g = torch.Generator(device="cuda").manual_seed(size)
    gy = torch.randn((batch, 1, 2 * size, 2 * size), device="cuda", generator=g).to(
        dtype).contiguous(memory_format=torch.channels_last)
    gx = torch.empty((batch, 1, size, size), device="cuda", dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    nbytes = (gy.numel() + gx.numel()) * gy.element_size()
    hw = ((size, size), (2 * size, 2 * size))
    rule = resize_mm.plan_backward(*hw, 1, gy.element_size(), True, batch)
    check(rule.route == "row", f"the rule sends the C = 1 gradient to {rule.route}")
    launcher(gy, gx, True, scalar=True)()
    want = gx.clone()

    def library():
        return torch.ops.aten.upsample_bilinear2d_backward(gy, list(hw[1]), list(gx.shape),
                                                           True, None, None)
    rows = [("scalar", device_ms(launcher(gy, gx, True, scalar=True)), 0),
            ("upsample_bilinear2d_backward", device_ms(library), 0)]
    for tile in ((rule.tile_h, rule.tile_w),) if quick else ROW_BWD_TILES:
        try:
            plan = resize_mm.plan_backward(*hw, 1, gy.element_size(), True, batch, tile)
        except ValueError:      # over the card's shared memory
            continue
        gx.zero_()
        fn = launcher(gy, gx, True, plan)
        fn()
        check(torch.equal(gx, want), f"row gradient tile {tile} differs from the scalar kernel")
        mark = " <- rule" if plan[:3] == rule[:3] else ""
        rows.append((f"row {tile[0]}x{tile[1]}{mark}", device_ms(fn), plan.smem_bytes))
    print(f"bwd {str(dtype)[6:]} {list(gx.shape)}<-{2 * size}^2: {nbytes / 1e6:.1f} MB, "
          f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (device time, a CUDA graph of 50 "
          f"launches replayed)")
    best = min(r[1] for r in rows[2:])
    for name, ms, smem in rows:
        print(f"    {name:30s} {ms:8.4f} ms  {nbytes / ms / 1e9:6.3f} TB/s  smem {smem:6d}"
              f"{'  *' if ms == best else ''}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="only the rule's tile at each shape (every lane count)")
    parser.add_argument("--row", action="store_true",
                        help="only the row route's sweep at the logits resize")
    parser.add_argument("--row-bwd", action="store_true",
                        help="only the row route's gradient sweep at the logits resize")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resize_tune: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    for line in _ext.build(["resize"])["resize"]["ptxas"]:
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")
    if args.row_bwd:
        for batch, dtype in ROW_CASES[1:]:
            sweep_row_bwd(batch, dtype, 256, args.quick)
        return
    for batch, dtype in ROW_CASES:
        sweep_row(batch, dtype, 256, args.quick)
    if args.row:
        return
    for backward in (False, True):
        for batch, dtype in ROW_CASES:
            for channels, size in LAYERS:
                sweep(batch, dtype, channels, size, backward, args.quick)


if __name__ == "__main__":
    main()
