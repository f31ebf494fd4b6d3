"""Time the fp32 conv3x3 + BN-moments kernel over its build-time choices on
the card.

    python -m vaeunet_tpu_torch.utils.conv_tune [--quick]

New in the port: the numbers behind ``kF32Chunk``, ``kF32Stages`` and the
blocks an SM is asked to hold in ``csrc/conv_bn_stats.cu`` (mirrored by
``F32_CHUNK`` / ``F32_STAGES`` in ``ops/pallas/conv_bn_stats.py``).  Each
candidate (input channels a stage, stages of the ``cp.async`` ring, blocks
per SM for ``__launch_bounds__``) is one more ``nvcc`` build of the same
source with ``-D`` overrides, all started together; each is held against
the plain version at a ragged and a deep shape, then timed (CUDA events,
the launch alone on prepared operands) at conv shapes of the 512^2 batch-16
training step, beside ``F.conv2d`` plus the two sums with TF32 off and the
fp32 operations bound.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import time

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats as cm

FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
# (input channels a stage, stages, blocks per SM)
VARIANTS = ((8, 3, 3), (8, 2, 3), (8, 4, 2), (8, 3, 2), (16, 2, 2), (16, 3, 1), (32, 2, 1))
# (x NCHW, Co): the widest, the deepest and a middle conv of the step
SHAPES = (((16, 224, 256, 256), 64), ((16, 64, 128, 128), 64), ((16, 256, 32, 32), 256),
          ((16, 512, 16, 16), 512))
CHECKS = (((2, 5, 12, 13), 7), ((1, 100, 17, 35), 72))
ENTRY = "vaeunet_conv3x3_stats_f32"
BUILT_IN = (cm.F32_CHUNK, cm.F32_STAGES, 2)      # the source's own defaults


def build_variants(variants) -> dict:
    """-> {variant: (ctypes function, ptxas lines)}; one nvcc per variant, in parallel."""
    out_dir = _ext.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        so = out_dir / f"conv_f32_c{v[0]}_s{v[1]}_b{v[2]}.so"
        cmd = [_ext.nvcc_path(), *_ext.NVCC_FLAGS, f"-DVAEUNET_F32_CHUNK={v[0]}",
               f"-DVAEUNET_F32_STAGES={v[1]}", f"-DVAEUNET_F32_BLOCKS_PER_SM={v[2]}",
               "-o", str(so), str(_ext.CSRC / "conv_bn_stats.cu")]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), so)
    built = {}
    for v, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {v}: nvcc exit {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), ENTRY)
        fn.argtypes = _ext.SIGNATURES["conv_bn_stats"][ENTRY]
        fn.restype = ctypes.c_int
        lines = log.splitlines()
        at = [i for i, ln in enumerate(lines) if "conv3x3_stats_f32_kernel" in ln
              and "Compiling" in ln]
        ptxas = [lines[j].strip() for i in at for j in range(i, min(i + 4, len(lines)))
                 if "registers" in lines[j] or "spill" in lines[j]]
        built[v] = (fn, ptxas)
    return built


def operands(shape, co, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn((co, shape[1], 3, 3), device="cuda", generator=g) / (3.0 * shape[1] ** 0.5)
    return x, w


def launcher(fn, x, w):
    """One launch of a variant on prepared operands -> (call, y, s, q, the
    weights the call reads: the caller keeps them alive while it launches)."""
    b, ci, h, wd = x.shape
    co = w.shape[0]
    pads = (cm._round_up(ci, cm.F32_CI_ALIGN), cm._round_up(co, cm.F32_CO_ALIGN))
    wk = cm.weights_tap_major(w, *pads)
    y = torch.empty((b, co, h, wd), device="cuda").contiguous(memory_format=torch.channels_last)
    tiles = cm.scratch_rows(b, h, wd)
    buf = torch.empty(2 * (tiles + 1) * co, device="cuda")
    p = buf.data_ptr()
    args = (x.data_ptr(), wk.data_ptr(), y.data_ptr(), p + 8 * co, p + 8 * co + 4 * tiles * co,
            p, p + 4 * co, b, h, wd, ci, co, *pads, tiles)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{ENTRY} failed with CUDA error {rc}")
    return call, y, buf[:co], buf[co:2 * co], wk


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def check_variant(fn, shape, co) -> None:
    x, w = operands(shape, co, seed=1)
    call, y, s, q, _ = launcher(fn, x, w)
    call()
    ry, rs, rq = cm.conv3x3_bn_stats_plain(x, w)
    mag = F.conv2d(x.abs(), w.abs(), padding=1)
    torch.cuda.synchronize()
    if not (bool(((y - ry).abs() <= 1e-5 * mag).all())
            and bool(((s - rs).abs() <= 1e-5 * ry.abs().sum(dim=(0, 2, 3))).all())
            and bool(((q - rq).abs() <= 1e-5 * rq).all())):
        raise AssertionError(f"{list(shape)}->{co}: differs from the plain version "
                             f"(max err {(y - ry).abs().max().item()})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="the main shape only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_tune: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    t0 = time.perf_counter()
    built = build_variants(VARIANTS)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    for v, (fn, ptxas) in built.items():
        smem = cm.fp32_smem_bytes(v[0], v[1])
        print(f"  chunk {v[0]} stages {v[1]} blocks/SM {v[2]}: smem {smem} B  {'; '.join(ptxas)}")
        for shape, co in CHECKS:
            check_variant(fn, shape, co)
    print("every variant matches the plain version")
    for shape, co in SHAPES[:1] if args.quick else SHAPES:
        x, w = operands(shape, co)
        b, ci, h, wd = shape
        flops = 2.0 * b * h * wd * ci * co * 9
        bound = flops / FP32_OPS_PER_S * 1e3

        def library():
            yl = F.conv2d(x, w, padding=1)
            return yl.sum(dim=(0, 2, 3)), yl.square().sum(dim=(0, 2, 3))
        iters = int(min(50, max(3, 0.3 / (3 * bound * 1e-3))))
        lib_ms = time_ms(library, iters)
        print(f"{list(shape)}->{co}: bound {bound:.4f} ms  F.conv2d+sums {lib_ms:.4f} ms "
              f"({flops / lib_ms / 1e9:.1f} TFLOP/s)")
        rows = []
        for v, (fn, _) in built.items():
            call, *_ = launcher(fn, x, w)
            rows.append((v, time_ms(call, iters)))
        best = min(ms for _, ms in rows)
        for v, ms in rows:
            mark = " <- built in" if v == BUILT_IN else ""
            print(f"    chunk {v[0]:2d} stages {v[1]} blocks/SM {v[2]}  {ms:8.4f} ms  "
                  f"{flops / ms / 1e9:5.1f} TFLOP/s{'  *' if ms == best else ''}{mark}")
        del x, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
