#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths (``vaeunet_tpu_torch``) on
the card, in phases that each fail the run with a non-zero exit:

1. device: name, count, versions, ``nvidia-smi`` name and power limit;
2. build: every ``vaeunet_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the shapes its path gives it, with timings (CUDA events) beside the
   bound and a PyTorch yardstick; the bf16 and the fp32 conv kernel at all
   12 conv shapes of the training step, a repeat call bit for bit, and
   their time per step (launches x ms) against ``F.conv2d`` plus the two
   sums; the resize kernels, forward and backward, at the request's five
   shapes (fp32, batch 8) and the step's five (bf16 and fp32, batch 16),
   through the wrapper and the launch alone, with their time per request
   and per step; at the one-channel logits resize the row kernel, the
   scalar kernel and the plain version bit for bit;
4. the slice: the full-width resnet34 VAE-UNet (random weights from a seed,
   randomized BN statistics) answers 3 uncertainty requests on a 2848x4288
   image, 512 tiles with overlap 100, N=10 samples at T=1, plus one sampled
   ``predict_image`` at 512^2.  Kernel launch counts are read over exactly
   this phase and held against the counts the code implies;
5. the card's slice against the CPU's on one 512^2 image, same weights and
   noise, TF32 off: samples atol 2e-4, mu/logvar atol 1e-4;
6. training: the flagship VAE-UNet (random weights from a seed) at 512^2,
   batch 16, bf16, no accumulation: the first step must change every
   parameter and leave it finite, then 3 warm-up and 10 timed steps, whose
   kernel launch counts are held against the counts the code implies, and
   one eval step on 16 images with a ``valid`` row mask;
7. the same step in fp32 (``amp=False``, TF32 off) at full width: 2 warm
   and 5 timed steps with their launch counts, p50, img/s and peak memory;
8. one fp32 train step (TF32 off) of the full-width resnet34 model at
   128^2, batch 2, accumulation 2, on the card and on the CPU from the same
   weights, batch and noise: loss atol 1e-5, running statistics atol 1e-4
   + rtol 1e-3, parameters atol 2 lr (+ 1e-6 for the fp32 rounding of
   p +- lr);
9. the plain UNet's request (``UNet(3, 1, bilinear=False)``, the top-level
   predict.py's default): 3 requests on a 1424x2144 image (a fundus at
   --scale 0.5), ``predict_image``, the probabilities resized back to
   2848x4288 (align_corners=False), the threshold; launch counts held; then
   the card against the CPU at 3x256x256, both ``bilinear`` settings;
10. the plain UNet's 512^2 batch-16 bf16 step, both ``bilinear`` settings:
   every parameter moves, 3 warm and 5 timed steps with their launch
   counts, one eval step, one fp32 step card vs CPU at 128^2;
11. the same for the resnet50 VAE-UNet with deep supervision;
12. remat: one fp32 resnet34 step at 256^2 batch 4 without remat, with
   'full' and with 'save_convs': the same loss, BN statistics and
   gradient, BN statistics moved once, less memory with 'full';
13. the training loop (``training.loop.train_model``) on a synthetic IDRiD
   set written from a seed into a temporary directory (4 train and 2 val
   fundus JPGs at IDRiD's 2848x4288 with EX TIF masks), the flagship at full
   width in bf16 at --scale 0.5, patch 512, batch 16, lr 1e-4, beta 0.001,
   2 epochs, the image-level device cache and the augmentation on: the
   native host library must build; one image-cache batch equals the host
   loader's bit for bit; each augmentation transform on the card equals the
   CPU's at the same parameters (tests/test_torch_augment.py's
   tolerances); the indexed augmented step moves every parameter; the
   loop's launches equal 37 conv, 5 resize (1 row), 5 resize backward and 2
   noise draws a train step plus 30 bn_relu, 5 resize (1 row) and 1 noise
   draw an eval step; a checkpoint round trip is exact; a resume from
   ``best`` runs one more epoch from the saved epoch + 1; one epoch runs
   host-fed (no cache, pinned copies).

Phase 3 also holds the conv kernel in both types at every conv shape of the
paths of phases 10 and 11 that the resnet34 step lacks (bf16 timed, with
each path's sum of launches x ms against its bound), the resize kernels,
forward and backward in both types, at the two shapes of those paths that
the resnet34 step lacks (the resnet50 decoder's [16,2048,16,16] -> 32^2,
the bilinear UNet's [16,64,256,256] -> 512^2), the one-channel resizes of
those paths (the mask downsamples by 4, 8 and 16 and the request's
upscale) bit for bit, ``bn_relu`` at phase 9's fp32 shapes (its
widest [1,64,1424,2144] and its odd-sized bottom [1,1024,89,134]), and the
noise kernel at phase 13's augmentation shape [16,512,512,3].

Serving and every comparison run in full fp32 (TF32 off for cuDNN
convolutions and matmuls); the training step of phase 6 in bf16.  The last
three lines are the kernels JSON, the ``nvidia-smi`` line and the result
JSON.  Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from vaeunet_tpu_torch import build_model, native, predict_image, segmentation_distribution
from vaeunet_tpu_torch.data import IDRIDDataset, augment
from vaeunet_tpu_torch.data.device_cache import (
    ImageDeviceCache,
    estimate_bytes,
    estimate_image_bytes,
)
from vaeunet_tpu_torch import uncertainty_maps, use_fp32_numerics
from vaeunet_tpu_torch.inference.tiled import compute_tile_grid
from vaeunet_tpu_torch.models import build_unet
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.ops.pallas import bn_relu as bn_relu_mod
from vaeunet_tpu_torch.ops.pallas import conv_bn_stats as conv_mod
from vaeunet_tpu_torch.ops.pallas import reparam as reparam_mod
from vaeunet_tpu_torch.ops.pallas import resize_mm
from vaeunet_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    train_model,
)
from vaeunet_tpu_torch.losses import make_criterion
from vaeunet_tpu_torch.training.step import forward_loss, to_model_layout
from vaeunet_tpu_torch.utils.tracking import Tracker
from vaeunet_tpu_torch.vae_utils import to_nchw

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense

IMAGE_HW = (2848, 4288)       # one IDRiD fundus at full resolution
PATCH, OVERLAP, TILE_BATCH = 512, 100, 8
N_SAMPLES, TEMPERATURE = 10, 1.0
N_REQUESTS = 3
# scalar operations per element, for the operations bound
PHILOX_BOX_MULLER_OPS = 146   # 10 Philox rounds (~100 integer ops) + uniforms + log/sqrt/cos
BN_RELU_OPS = 3               # mul, add, max
RESIZE_OPS = 9                # 3 lerps of (sub, mul, mul, add) sharing the (1 - lambda)


# numbers one phase reports for a later one to print beside its own
SUMMARY: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
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


def iters_for(nbytes: float) -> int:
    return int(min(200, max(20, 2e9 / max(nbytes, 1.0))))


def time_auto(fn, budget_s: float = 0.25) -> float:
    """time_ms with as many launches as fit in about `budget_s` (3 to 100),
    for calls whose time spans milliseconds to tens of them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    return time_ms(fn, int(min(100, max(3, budget_s / max(once, 1e-6)))), warmup=1)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ----- phase 1 -------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name} x{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"nvidia-smi: {smi}")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


# ----- phase 2 -------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    info = _ext.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(info)}")
    for name, rec in info.items():
        took = "cached" if rec["seconds"] is None else f"{rec['seconds']:.1f} s"
        log(f"  {name}.cu -> {rec['path']} ({took})")
        for line in rec["ptxas"]:
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    for name in info:
        _ext.library(name)


# ----- phase 3 -------------------------------------------------------------

def _record(table: dict, name: str, **kw) -> None:
    rec = table.setdefault(name, {"max_abs_err": 0.0})
    err = kw.pop("err", None)
    if err is not None:
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec.update(kw)


# (NCHW, types): the VAE-UNet request's widest and narrowest pairs, then the
# plain UNet request's (fp32 at 1424x2144): its widest tensor, and the
# bottom's odd 89x134
BN_RELU_SHAPES = (((8, 64, 256, 256), (torch.float32, torch.bfloat16)),
                  ((8, 512, 16, 16), (torch.float32, torch.bfloat16)),
                  ((1, 64, 1424, 2144), (torch.float32,)),
                  ((1, 1024, 89, 134), (torch.float32,)))


def kernel_bn_relu(table: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape, dtypes in BN_RELU_SHAPES:
        c = shape[1]
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g)
        mean = torch.randn(c, device="cuda", generator=g) * 0.5
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        a, b = bn_relu_mod.fold(scale, bias, mean, var)
        for dtype in dtypes:
            x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last)
            y = bn_relu_mod.fused_bn_relu(x, scale, bias, mean, var)
            ref = bn_relu_mod.fused_bn_relu_plain(x, a, b)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= 1e-6, f"bn_relu fp32 {shape}: max err {err} > 1e-6")
            else:   # one bf16 ulp
                ulp_ok = ((y.float() - ref.float()).abs()
                          <= ref.float().abs() * 2.0 ** -7).all().item()
                check(ulp_ok, f"bn_relu bf16 {shape}: differs by more than 1 ulp")
            nbytes = 2 * x.numel() * x.element_size()
            it = iters_for(nbytes)
            k_ms = time_ms(lambda: bn_relu_mod.fused_bn_relu(x, scale, bias, mean, var), it)
            p_ms = time_ms(lambda: bn_relu_mod.fused_bn_relu_plain(x, a, b), it)
            l_ms = time_ms(lambda: F.relu_(F.batch_norm(x, mean, var, scale, bias, False,
                                                       0.0, 1e-5)), it)
            bnd, by = bound_ms(nbytes, BN_RELU_OPS * x.numel())
            log(f"bn_relu {list(shape)} {str(dtype)[6:]}: err {err:.3g}  kernel {k_ms:.4f} ms  "
                f"plain {p_ms:.4f} ms  F.batch_norm+relu {l_ms:.4f} ms  bound {bnd:.4f} ms")
            main = shape == (8, 64, 256, 256) and dtype == torch.float32
            _record(table, "bn_relu", err=err, **(dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
                shape=f"{list(shape)} fp32") if main else {}))


# (input NCHW, output H = W) of the model's five resizes (four decoder
# upsamples and the logits'): the request's at batch 8, the step's at batch 16
RESIZE_SHAPES = (((8, 512, 16, 16), 32), ((8, 512, 32, 32), 64), ((8, 256, 64, 64), 128),
                 ((8, 128, 128, 128), 256), ((8, 1, 256, 256), 512))
RESIZE_BWD_SHAPES = (((16, 512, 16, 16), 32), ((16, 512, 32, 32), 64),
                     ((16, 256, 64, 64), 128), ((16, 128, 128, 128), 256),
                     ((16, 1, 256, 256), 512))
# the resizes of the plain UNet's and the resnet50 VAE-UNet's steps that
# the resnet34 step lacks: the resnet50 decoder's first upsample and the
# bilinear UNet's last, forward and backward
NEW_PATH_RESIZES = (((16, 2048, 16, 16), 32), ((16, 64, 256, 256), 512))
# (shapes, type, what the sum of its launches x ms is called)
RESIZE_SETS = ((RESIZE_SHAPES, torch.float32, "request (100 launches a shape)", 100),
               (RESIZE_BWD_SHAPES, torch.bfloat16, "512^2 b16 bf16 step", 1),
               (RESIZE_BWD_SHAPES, torch.float32, "512^2 b16 fp32 step", 1),
               (NEW_PATH_RESIZES, torch.bfloat16, "the new paths' two extra bf16 shapes", 1),
               (NEW_PATH_RESIZES, torch.float32, "the new paths' two extra fp32 shapes", 1))


def resize_launch_only(src, dst, ac: bool, backward: bool):
    """The kernel's launch alone on tensors made beforehand: the device
    time where the wrapper's allocation and host work would hide it."""
    fn, args = resize_mm.launch_args(src, dst, ac, backward=backward)
    return lambda: _ext.call("resize", fn, src.device, *args)


def log_resize_sums(name: str, what: str, library: str, sums: dict) -> None:
    log(f"{name} per {what}: kernel {sums['kernel']:.3f} ms (launch alone "
        f"{sums['launch']:.3f} ms)  {library} {sums['library']:.3f} ms  "
        f"bound {sums['bound']:.3f} ms")


def spread_ms(fn, iters: int, rounds: int = 3) -> tuple:
    """(least, most) of `rounds` time_ms of fn: a call whose time is the
    host's launch work varies between rounds."""
    times = [time_ms(fn, iters) for _ in range(rounds)]
    return min(times), max(times)


def kernel_resize(table: dict) -> None:
    """fp32 within 1e-6 of the plain version and 1e-5 of F.interpolate, both
    conventions; bf16 (blended in fp32, rounded once) within one bf16 ulp of
    the plain version; a second call the same bits; where the tiled or the
    row kernel runs, the scalar kernel on the same input gives the same
    bits; at C = 1 (the row kernel) the plain version's bits as well."""
    g = torch.Generator(device="cuda").manual_seed(2)
    for shapes, dtype, what, per in RESIZE_SETS:
        sums = {"kernel": 0.0, "launch": 0.0, "library": 0.0, "bound": 0.0}
        for shape, out in shapes:
            for ac in (True, False):
                x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                y = resize_mm.resize(x, (out, out), ac)
                ref = resize_mm.resize_plain(x, (out, out), ac)
                torch.cuda.synchronize()
                name = f"resize {list(shape)}->{out}^2 {str(dtype)[6:]} ac={ac}"
                err = (y.float() - ref.float()).abs().max().item()
                if dtype == torch.float32:
                    lib = F.interpolate(x, size=(out, out), mode="bilinear", align_corners=ac)
                    err_lib = (y - lib).abs().max().item()
                    check(err <= 1e-6, f"{name}: err {err} > 1e-6")
                    check(err_lib <= 1e-5, f"{name}: err vs F.interpolate {err_lib} > 1e-5")
                    del lib
                else:
                    check(((y.float() - ref.float()).abs()
                           <= ref.float().abs() * 2.0 ** -7).all().item(),
                          f"{name}: differs from the plain version by more than 1 ulp")
                check(torch.equal(y, resize_mm.resize(x, (out, out), ac)),
                      f"{name}: a second call gave other bits")
                other = torch.empty_like(y)
                fn, args = resize_mm.launch_args(x, other, ac, scalar=True)
                _ext.call("resize", fn, x.device, *args)
                check(torch.equal(y, other), f"{name}: the chosen and the scalar kernels differ")
                one_channel = shape[1] == 1
                if one_channel:
                    check("_row_" in resize_mm.launch_args(x, y, ac)[0],
                          f"{name}: did not take the row kernel")
                    check(torch.equal(y, ref), f"{name}: the row kernel and the plain version differ")
                del ref, other
                _record(table, "resize_c1" if one_channel else "resize", err=err)
                if not ac:
                    log(f"{name}: err {err:.3g}")
                    continue
                nbytes = (x.numel() + y.numel()) * x.element_size()
                it = iters_for(nbytes)

                def library():
                    return F.interpolate(x, size=(out, out), mode="bilinear", align_corners=ac)
                k_ms = time_ms(lambda: resize_mm.resize(x, (out, out), ac), it)
                p_ms = time_ms(lambda: resize_mm.resize_plain(x, (out, out), ac), it)
                extra = ""
                if one_channel:
                    # microseconds each: the row kernel, the scalar kernel it replaced
                    # and the library call in turns, the least of three rounds
                    fn, args = resize_mm.launch_args(x, y, ac, scalar=True)
                    t = paired_ms({"alone": resize_launch_only(x, y, ac, False),
                                   "scalar": lambda: _ext.call("resize", fn, x.device, *args),
                                   "library": library}, 1000)
                    a_ms, l_ms = t["alone"], t["library"]
                    extra = (f"  scalar kernel alone {t['scalar']:.4f} ms  (row kernel "
                             f"{'no slower than' if a_ms <= l_ms else 'SLOWER than'} "
                             f"F.interpolate)")
                else:
                    a_ms = time_ms(resize_launch_only(x, y, ac, False), it)
                    l_ms = time_ms(library, it)
                if one_channel or shape == (8, 512, 16, 16):
                    # host-bound through the wrapper: the spread between rounds
                    lo, hi = spread_ms(lambda: resize_mm.resize(x, (out, out), ac), 1000)
                    extra += f"  wrapper over 3 rounds {lo:.4f}-{hi:.4f} ms"
                bnd, by = bound_ms(nbytes, RESIZE_OPS * y.numel())
                for k, v in (("kernel", k_ms), ("launch", a_ms), ("library", l_ms),
                             ("bound", bnd)):
                    sums[k] += per * v
                log(f"{name}: err {err:.3g}  kernel {k_ms:.4f} ms  launch alone {a_ms:.4f} ms "
                    f"({nbytes / a_ms / 1e9:.3f} TB/s)  plain {p_ms:.4f} ms  "
                    f"F.interpolate {l_ms:.4f} ms  bound {bnd:.4f} ms{extra}")
                if shape == (8, 1, 256, 256) and dtype == torch.float32:
                    # through the wrapper the call is the host's Python work (as is
                    # F.interpolate's): the kernel's own time is the launch alone, timed
                    # in turns with the library call
                    _record(table, "resize_c1", ms=a_ms, wrapper_ms=k_ms, plain_ms=p_ms,
                            library_ms=l_ms, bound_ms=bnd, bound_by=by,
                            shape=f"{list(shape)}->{out}^2 fp32")
                if shape == (8, 128, 128, 128) and dtype == torch.float32:
                    _record(table, "resize", ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                            bound_ms=bnd, bound_by=by, shape=f"{list(shape)}->{out}^2 fp32")
        log_resize_sums("resize", what, "F.interpolate", sums)
        torch.cuda.empty_cache()


# one-channel resizes with align_corners=False on the new paths: the
# resnet50 step's three mask downsamples for deep supervision, and the
# plain UNet request's probability upscale to the full fundus
C1_PATH_RESIZES = (((16, 1, 512, 512), (128, 128)), ((16, 1, 512, 512), (64, 64)),
                   ((16, 1, 512, 512), (32, 32)), ((1, 1, 1424, 2144), (2848, 4288)))


def kernel_resize_c1_paths(table: dict) -> None:
    """The row kernel, the scalar kernel and the plain version bit for bit
    at each shape, the route and tile the plan picks, and the launch alone
    beside F.interpolate."""
    g = torch.Generator(device="cuda").manual_seed(12)
    for shape, out in C1_PATH_RESIZES:
        x = torch.rand(shape, device="cuda", generator=g).contiguous(
            memory_format=torch.channels_last)
        plan = resize_mm.plan_forward(shape[2:], out, 1, 4, False, shape[0])
        y = resize_mm.resize(x, out, False)
        ref = resize_mm.resize_plain(x, out, False)
        other = torch.empty_like(y)
        fn, args = resize_mm.launch_args(x, other, False, scalar=True)
        _ext.call("resize", fn, x.device, *args)
        torch.cuda.synchronize()
        name = f"resize {list(shape)}->{list(out)} fp32 ac=False"
        check("_row_" in resize_mm.launch_args(x, y, False)[0], f"{name}: not the row kernel")
        check(torch.equal(y, ref), f"{name}: the row kernel and the plain version differ")
        check(torch.equal(y, other), f"{name}: the row and the scalar kernels differ")
        nbytes = (x.numel() + y.numel()) * 4
        it = iters_for(nbytes)
        t = paired_ms({"alone": resize_launch_only(x, y, False, False),
                       "library": lambda: F.interpolate(x, size=out, mode="bilinear",
                                                        align_corners=False)}, it)
        bnd, _ = bound_ms(nbytes, RESIZE_OPS * y.numel())
        log(f"{name}: bit for bit (row = scalar = plain)  tile {plan.tile_h}x{plan.tile_w}, "
            f"{plan.blocks} blocks, {plan.smem_bytes} B shared  launch alone {t['alone']:.4f} ms  "
            f"F.interpolate {t['library']:.4f} ms  bound {bnd:.4f} ms")
        del x, y, ref, other
    torch.cuda.empty_cache()


def paired_ms(fns: dict, iters: int, rounds: int = 3) -> dict:
    """time_ms of each fn, in turns over `rounds` rounds, the least of each:
    calls whose time is the host's launch work vary between rounds."""
    best = {k: float("inf") for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            best[k] = min(best[k], time_ms(fn, iters))
    return best


AUG_NOISE_SHAPE = (16, 512, 512, 3)    # the augmentation's Gauss noise, one draw a step


def kernel_noise(table: dict) -> None:
    for shape in ((8192, 64), (3, 32), (1, 32), AUG_NOISE_SHAPE):
        z = reparam_mod.normal(shape, 11, "cuda")
        ref = reparam_mod.normal_plain(shape, 11, "cuda")
        torch.cuda.synchronize()
        err = (z - ref).abs().max().item()
        check(err <= 1e-5, f"normal {shape}: err {err} vs plain > 1e-5")
        check(torch.equal(z, reparam_mod.normal(shape, 11, "cuda")),
              f"normal {shape}: same seed gave different values")
        check(not torch.equal(z, reparam_mod.normal(shape, 12, "cuda")),
              f"normal {shape}: a new seed gave the same values")
        if shape in ((8192, 64), AUG_NOISE_SHAPE):
            m, s = z.mean().item(), z.std().item()
            check(abs(m) < 0.01 and abs(s - 1) < 0.01, f"normal moments {m} {s}")
            log(f"normal {list(shape)}: mean {m:.5f} std {s:.5f}")
        n = z.numel()
        dev = torch.device("cuda")
        t = paired_ms({"kernel": lambda: reparam_mod.normal(shape, 11, dev),
                       "randn": lambda: torch.randn(shape, device=dev)},
                      100 if shape == AUG_NOISE_SHAPE else 1000)
        k_ms, l_ms = t["kernel"], t["randn"]
        # the launch alone into a tensor made beforehand: what is left of the
        # wrapper's time is its allocation and checks
        a_ms = time_ms(lambda: _ext.call("reparam", "vaeunet_normal", dev, z.data_ptr(), n, 11),
                       1000)
        p_ms = time_ms(lambda: reparam_mod.normal_plain(shape, 11, "cuda"),
                       10 if shape == AUG_NOISE_SHAPE else 200)
        bnd, by = bound_ms(4 * n, PHILOX_BOX_MULLER_OPS * n)
        log(f"normal {list(shape)}: err {err:.3g}  kernel {k_ms:.4f} ms  launch alone "
            f"{a_ms:.4f} ms  plain {p_ms:.4f} ms  torch.randn {l_ms:.4f} ms  "
            f"bound {bnd:.6f} ms  "
            f"(kernel {'no slower than' if k_ms <= l_ms else 'SLOWER than'} torch.randn)")
        main = shape == (1, 32)
        _record(table, "normal", err=err, **(dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
            shape="[1, 32]") if main else {}))
        if shape == AUG_NOISE_SHAPE:
            _record(table, "normal", augmentation_shape=dict(
                shape=str(list(shape)), ms=k_ms, launch_alone_ms=a_ms, plain_ms=p_ms,
                library_ms=l_ms, bound_ms=bnd, bound_by=by))


def kernel_reparam(table: dict) -> None:
    # the tests/test_pallas.py:80-102 case
    n = 4096
    mu = torch.tensor([1.0, -2.0], device="cuda").expand(n, 2).contiguous()
    logvar = torch.tensor([0.0, 1.3862943611198906], device="cuda").expand(n, 2).contiguous()
    z = reparam_mod.reparameterize(mu, logvar, 7, 1.0)
    ref = reparam_mod.reparameterize_plain(mu, logvar, 7, 1.0)
    torch.cuda.synchronize()
    err = (z - ref).abs().max().item()
    check(err <= 5e-5, f"reparam: err {err} vs plain > 5e-5")
    check(torch.allclose(z.mean(0), torch.tensor([1.0, -2.0], device="cuda"), atol=0.15),
          f"reparam mean {z.mean(0).tolist()}")
    check(torch.allclose(z.std(0), torch.tensor([1.0, 2.0], device="cuda"), rtol=0.1),
          f"reparam std {z.std(0).tolist()}")
    z2 = reparam_mod.reparameterize(mu, logvar, 7, 2.0)
    check(torch.allclose(z2.std(0), torch.tensor([2.0, 4.0], device="cuda"), rtol=0.1),
          f"reparam T=2 std {z2.std(0).tolist()}")
    check(torch.equal(z, reparam_mod.reparameterize(mu, logvar, 7, 1.0)), "reparam: seed repeat")
    check(not torch.equal(z, reparam_mod.reparameterize(mu, logvar, 8, 1.0)), "reparam: new seed")
    log(f"reparam [4096, 2]: err {err:.3g}  mean {z.mean(0).tolist()}  std {z.std(0).tolist()}")
    # timed at the serving shape: N=10 draws of one image's [1, 32] posterior
    g = torch.Generator(device="cuda").manual_seed(3)
    mu = torch.randn((N_SAMPLES, 32), device="cuda", generator=g)
    logvar = torch.rand((N_SAMPLES, 32), device="cuda", generator=g) * 4 - 2
    err = (reparam_mod.reparameterize(mu, logvar, 5, TEMPERATURE)
           - reparam_mod.reparameterize_plain(mu, logvar, 5, TEMPERATURE)).abs().max().item()
    check(err <= 5e-5, f"reparam [10, 32]: err {err} vs plain > 5e-5")
    k_ms = time_ms(lambda: reparam_mod.reparameterize(mu, logvar, 5, TEMPERATURE), 200)
    p_ms = time_ms(lambda: reparam_mod.reparameterize_plain(mu, logvar, 5, TEMPERATURE), 200)
    n = mu.numel()
    z = torch.empty_like(mu)
    a_ms = time_ms(lambda: _ext.call("reparam", "vaeunet_reparam", mu.device, mu.data_ptr(),
                                     logvar.data_ptr(), TEMPERATURE, z.data_ptr(), n, 5), 1000)
    bnd, by = bound_ms(12 * n, (PHILOX_BOX_MULLER_OPS + 5) * n)
    log(f"reparam [10, 32]: err {err:.3g}  kernel {k_ms:.4f} ms  launch alone {a_ms:.4f} ms  "
        f"plain {p_ms:.4f} ms  bound {bnd:.6f} ms")
    _record(table, "reparam", err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            bound_ms=bnd, bound_by=by, shape="[10, 32]")


# (x NCHW, Co, launches per step) of the 512^2 batch-16 step's 37 conv-kernel
# launches: encoder stages 1-4 (every block's conv2 and its stride-1 conv1),
# then decoder_0..3 conv1 ([x, skip, z] in) and conv2
CONV_STEP = (((16, 64, 128, 128), 64, 6), ((16, 128, 64, 64), 128, 7),
             ((16, 256, 32, 32), 256, 11), ((16, 512, 16, 16), 512, 5),
             ((16, 800, 32, 32), 512, 1), ((16, 512, 32, 32), 512, 1),
             ((16, 672, 64, 64), 256, 1), ((16, 256, 64, 64), 256, 1),
             ((16, 352, 128, 128), 128, 1), ((16, 128, 128, 128), 128, 1),
             ((16, 224, 256, 256), 64, 1), ((16, 64, 256, 256), 64, 1))
# both types at all of them, and at a ragged case: Ci off a vector, Co, H, W
# off every tile
CONV_RAGGED = ((2, 5, 12, 13), 7)
CONV_MAIN = ((16, 224, 256, 256), 64)


def conv_launch_only(x, w):
    """The kernel's launch alone, its operands made beforehand (bf16: x
    padded to a multiple of 8 channels, as the wrapper pads it): the device
    time where the wrapper's host work would hide it."""
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if x.dtype == torch.bfloat16:
        ci_k = -(-ci // conv_mod.CI_ALIGN) * conv_mod.CI_ALIGN
        if ci_k != ci:
            x = conv_mod.pad_channels(x, ci_k)
        wk, dims = conv_mod.weights_k_major(w, ci_k), (ci_k, co)
        fn = "vaeunet_conv3x3_stats_bf16_wgmma"
    else:
        pads = (-(-ci // conv_mod.F32_CI_ALIGN) * conv_mod.F32_CI_ALIGN,
                -(-co // conv_mod.F32_CO_ALIGN) * conv_mod.F32_CO_ALIGN)
        wk, dims = conv_mod.weights_tap_major(w, *pads), (ci, co, *pads)
        fn = "vaeunet_conv3x3_stats_f32"
    y = torch.empty((b, co, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    tiles = conv_mod.scratch_rows(b, h, wd)
    buf = torch.empty(2 * (tiles + 1) * co, device=x.device)
    p = buf.data_ptr()
    args = (x.data_ptr(), wk.data_ptr(), y.data_ptr(), p + 8 * co, p + 8 * co + 4 * tiles * co,
            p, p + 4 * co, b, h, wd, *dims, tiles)

    def launch(keep=(x, wk, y, buf)):   # the operands live as long as the launcher
        _ext.call("conv_bn_stats", fn, x.device, *args)
    return launch


def conv_case(g, shape, co, dtype, launch_alone: bool = False, timed: bool = True) -> dict:
    """y within 1e-5 of the summed magnitudes (conv of |x| with |w|) in
    fp32, the room fp32 rounding in another order needs; in bf16 one bf16
    ulp more, since the two fp32 values can round to neighbours (the tensor
    cores sum in another order than cuDNN's fp32 reference).  s within 1e-5
    (fp32) or 1e-4 (bf16) of sum |y|, q relative 1e-5 / 1e-4: both sides sum
    the same fp32 values in another order.  A second call must give the
    same bits.  `launch_alone` also times the kernel's launch without the
    wrapper; `timed=False` only checks."""
    x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((co, shape[1], 3, 3), device="cuda", generator=g)
         / (3.0 * shape[1] ** 0.5)).to(dtype)
    y, s, q = conv_mod.conv3x3_bn_stats(x, w)
    ry, rs, rq = conv_mod.conv3x3_bn_stats_plain(x, w)
    mag = F.conv2d(x.float().abs(), w.float().abs(), padding=1)
    torch.cuda.synchronize()
    what = f"conv_bn_stats {list(shape)}->{co} {str(dtype)[6:]}"
    diff = (y.float() - ry.float()).abs()
    err = diff.max().item()
    rel = 1e-5 if dtype == torch.float32 else 1e-4
    room = 1e-5 * mag
    if dtype != torch.float32:
        room = room + torch.maximum(y.float().abs(), ry.float().abs()) * 2.0 ** -7
    check(bool((diff <= room).all()), f"{what}: y outside tolerance (max err {err})")
    s_room = rel * ry.float().abs().sum(dim=(0, 2, 3))
    check(bool(((s - rs).abs() <= s_room).all()), f"{what}: sums differ")
    check(bool(((q - rq).abs() <= rel * rq).all()), f"{what}: squares differ")
    s_err = max((s - rs).abs().max().item(), (q - rq).abs().max().item())
    del mag, diff, room, ry
    y2, s2, q2 = conv_mod.conv3x3_bn_stats(x, w)
    check(torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(q, q2),
          f"{what}: a second call gave other bits")
    del y2, s2, q2
    b, ci, h, wd = shape
    macs = b * h * wd * ci * co * 9
    esize = x.element_size()
    nbytes = (x.numel() + w.numel() + b * co * h * wd) * esize + 2 * co * 4
    peak = FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    bnd, by = bound_ms(nbytes, 2.0 * macs, peak)
    if not timed:
        log(f"{what}: y err {err:.3g} moments err {s_err:.3g}  (checked, not timed)")
        return dict(err=err)
    k_ms = time_auto(lambda: conv_mod.conv3x3_bn_stats(x, w))
    launch_ms = time_auto(conv_launch_only(x, w)) if launch_alone else None
    p_ms = time_auto(lambda: conv_mod.conv3x3_bn_stats_plain(x, w))

    def library():
        yl = F.conv2d(x, w, padding=1)
        return yl.sum(dim=(0, 2, 3), dtype=torch.float32), \
            yl.square().sum(dim=(0, 2, 3), dtype=torch.float32)
    l_ms = time_auto(library)
    alone = "" if launch_ms is None else \
        f" (launch alone {launch_ms:.4f} ms, {2 * macs / launch_ms / 1e9:.1f} TFLOP/s)"
    log(f"{what}: y err {err:.3g} moments err {s_err:.3g}  kernel {k_ms:.4f} ms "
        f"({2 * macs / k_ms / 1e9:.1f} TFLOP/s){alone}  plain {p_ms:.4f} ms  "
        f"F.conv2d+sums {l_ms:.4f} ms  bound {bnd:.4f} ms ({by})")
    return dict(err=err, ms=k_ms, launch_ms=launch_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=bnd, bound_by=by)


def unet_convs(bilinear: bool, b: int = 16, hw: int = 512) -> list:
    """(x NCHW, Co) of the plain UNet's 18 conv-kernel launches a training
    forward: inc and down1-4 ((in, mid, out) each), then up1-4."""
    f = 2 if bilinear else 1
    convs, h = [], hw
    for i, (ci, co) in enumerate(((3, 64), (64, 128), (128, 256), (256, 512), (512, 1024 // f))):
        h = hw >> i
        convs += [((b, ci, h, h), co), ((b, co, h, h), co)]
    for ci, co in ((1024, 512 // f), (512, 256 // f), (256, 128 // f), (128, 64)):
        h *= 2
        mid = ci // 2 if bilinear else co
        convs += [((b, ci, h, h), mid), ((b, mid, h, h), co)]
    return convs


# the resnet50 VAE-UNet's 21: the 13 stride-1 bottleneck conv2s, then the
# decoder's 8, whose first conv takes 2048 + 1024 + 32 = 3104 channels
R50_CONVS = ([((16, 64, 128, 128), 64)] * 3 + [((16, 128, 64, 64), 128)] * 3
             + [((16, 256, 32, 32), 256)] * 5 + [((16, 512, 16, 16), 512)] * 2
             + [((16, 3104, 32, 32), 512), ((16, 512, 32, 32), 512),
                ((16, 1056, 64, 64), 256), ((16, 256, 64, 64), 256),
                ((16, 544, 128, 128), 128), ((16, 128, 128, 128), 128),
                ((16, 224, 256, 256), 64), ((16, 64, 256, 256), 64)])
NEW_PATHS = (("UNet", unet_convs(False)), ("UNet bilinear", unet_convs(True)),
             ("resnet50 VAE-UNet", R50_CONVS))


def kernel_conv_bn_stats(table: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(7)
    bf16 = {}                    # (shape, Co) -> timings of the bf16 kernel
    for dtype, entry in ((torch.bfloat16, "conv_bn_stats"), (torch.float32, "conv_bn_stats_fp32")):
        per_step = {"kernel": 0.0, "launch": 0.0, "library": 0.0, "bound": 0.0}
        lost = []
        for shape, co, n in CONV_STEP:
            r = conv_case(g, shape, co, dtype, launch_alone=True)
            if dtype == torch.bfloat16:
                bf16[(shape, co)] = r
            for k, key in (("kernel", "ms"), ("launch", "launch_ms"), ("library", "library_ms"),
                           ("bound", "bound_ms")):
                per_step[k] += n * r[key]
            if r["launch_ms"] > r["library_ms"]:
                lost.append(f"{list(shape)}->{co}")
            _record(table, entry, err=r["err"], **(dict(
                ms=r["ms"], launch_ms=r["launch_ms"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                shape=f"{list(shape)}->{co} {'bf16' if dtype == torch.bfloat16 else 'fp32'}")
                if (shape, co) == CONV_MAIN else {}))
            torch.cuda.empty_cache()
        log(f"{entry} per 512^2 b16 {str(dtype)[6:]} step (sum of launches x ms over the 37 "
            f"launches): kernel {per_step['kernel']:.3f} ms (launch alone "
            f"{per_step['launch']:.3f} ms)  F.conv2d+sums {per_step['library']:.3f} ms  "
            f"bound {per_step['bound']:.3f} ms  launch alone slower than F.conv2d+sums at: "
            f"{lost or 'no shape'}")
        _record(table, entry, err=conv_case(g, *CONV_RAGGED, dtype)["err"])
    kernel_conv_new_shapes(table, g, bf16)


def kernel_conv_new_shapes(table: dict, g, bf16: dict) -> None:
    """The shapes of the plain UNet's and the resnet50 VAE-UNet's steps
    that the resnet34 step does not have (Ci = 3 at 512^2, the ragged
    K chunks of Ci = 3104, 1056, 544, ...): both types held against the
    plain version, the bf16 launches timed beside F.conv2d + 2 sums, and
    each path's sum of launches x ms against its bound."""
    new = sorted({c for _, convs in NEW_PATHS for c in convs} - set(bf16),
                 key=lambda c: (c[0][1], c[0][2], c[1]))
    for shape, co in new:
        bf16[(shape, co)] = conv_case(g, shape, co, torch.bfloat16, launch_alone=True)
        _record(table, "conv_bn_stats", err=bf16[(shape, co)]["err"])
        _record(table, "conv_bn_stats_fp32",
                err=conv_case(g, shape, co, torch.float32, timed=False)["err"])
        torch.cuda.empty_cache()
    for name, convs in NEW_PATHS:
        sums = {k: sum(bf16[c][k] for c in convs)
                for k in ("ms", "launch_ms", "library_ms", "bound_ms")}
        lost = sorted({f"{list(c[0])}->{c[1]}" for c in convs
                       if bf16[c]["launch_ms"] > bf16[c]["library_ms"]})
        log(f"conv_bn_stats per 512^2 b16 bf16 {name} step (sum over its {len(convs)} "
            f"launches): kernel {sums['ms']:.3f} ms (launch alone {sums['launch_ms']:.3f} ms)  "
            f"F.conv2d+sums {sums['library_ms']:.3f} ms  bound {sums['bound_ms']:.3f} ms  "
            f"launch alone slower than F.conv2d+sums at: {lost or 'no shape'}")


def kernel_resize_bwd(table: dict) -> None:
    """gx = M^T g against the plain version (index_add_ with atomics on the
    card, so fp32 order differs: 1e-6 of the summed magnitudes M^T |g|; bf16
    is summed in fp32 and rounded once, so one bf16 ulp more) and, in fp32,
    against autograd's upsample_bilinear2d_backward (1e-5 of them; in bf16
    that one accumulates in bf16 and is only timed).  A second call gives
    the same bits, and so does the scalar kernel where the tiled one runs."""
    g = torch.Generator(device="cuda").manual_seed(8)
    for shapes, dtype, what, per in RESIZE_SETS:
        sums = {"kernel": 0.0, "launch": 0.0, "library": 0.0, "bound": 0.0}
        for shape, out in shapes:
            gy = torch.randn((shape[0], shape[1], out, out), device="cuda", generator=g).to(
                dtype).contiguous(memory_format=torch.channels_last)
            gx = resize_mm.resize_backward(gy, shape[2:], True)
            ref = resize_mm.resize_backward_plain(gy, shape[2:], True)
            lib = torch.ops.aten.upsample_bilinear2d_backward(gy, [out, out], list(shape),
                                                               True, None, None)
            mag = resize_mm.resize_backward_plain(gy.float().abs(), shape[2:], True)
            torch.cuda.synchronize()
            name = f"resize_bwd {list(shape)}<-{out}^2 {str(dtype)[6:]}"
            ulp = 0.0 if dtype == torch.float32 else gx.float().abs() * 2.0 ** -7
            err = (gx.float() - ref.float()).abs()
            check(bool((err <= 1e-6 * mag + ulp).all()), f"{name}: differs from the plain version")
            if dtype == torch.float32:
                check(bool(((gx - lib).abs() <= 1e-5 * mag).all()),
                      f"{name}: differs from upsample_bilinear2d_backward")
            err = err.max().item()
            check(torch.equal(gx, resize_mm.resize_backward(gy, shape[2:], True)),
                  f"{name}: a second call gave other bits")
            other = torch.empty_like(gx)
            fn, args = resize_mm.launch_args(gy, other, True, backward=True, scalar=True)
            _ext.call("resize", fn, gy.device, *args)
            check(torch.equal(gx, other), f"{name}: the tiled and scalar kernels differ")
            del ref, lib, mag, other
            nbytes = (gy.numel() + gx.numel()) * gy.element_size()
            bnd, by = bound_ms(nbytes, RESIZE_OPS * gy.numel())
            it = iters_for(nbytes)
            k_ms = time_ms(lambda: resize_mm.resize_backward(gy, shape[2:], True), it)
            a_ms = time_ms(resize_launch_only(gy, gx, True, True), it)
            p_ms = time_ms(lambda: resize_mm.resize_backward_plain(gy, shape[2:], True), it)
            l_ms = time_ms(lambda: torch.ops.aten.upsample_bilinear2d_backward(
                gy, [out, out], list(shape), True, None, None), it)
            for k, v in (("kernel", k_ms), ("launch", a_ms), ("library", l_ms), ("bound", bnd)):
                sums[k] += per * v
            log(f"{name}: err {err:.3g}  kernel {k_ms:.4f} ms  launch alone {a_ms:.4f} ms "
                f"({nbytes / a_ms / 1e9:.3f} TB/s)  plain {p_ms:.4f} ms  "
                f"upsample_bilinear2d_backward {l_ms:.4f} ms  bound {bnd:.4f} ms")
            main = shape == (16, 128, 128, 128) and dtype == torch.bfloat16
            _record(table, "resize_bwd", err=err, **(dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
                shape=f"{list(shape)}<-{out}^2 bf16") if main else {}))
        log_resize_sums("resize_bwd", what.replace("request", "request's shapes"),
                        "upsample_bilinear2d_backward", sums)
        torch.cuda.empty_cache()


def phase_kernels() -> dict:
    table: dict = {}
    kernel_bn_relu(table)
    kernel_resize(table)
    kernel_resize_c1_paths(table)
    kernel_noise(table)
    kernel_reparam(table)
    kernel_conv_bn_stats(table)
    kernel_resize_bwd(table)
    return table


# ----- phase 4 -------------------------------------------------------------

def randomize_bn_stats(model: torch.nn.Module, seed: int) -> None:
    """Fresh (0, 1) running statistics would hide a mapping bug."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)


def expected_launches() -> dict:
    """Launches the serving path's code implies for this phase."""
    n_tiles = len(compute_tile_grid(*IMAGE_HW, PATCH, OVERLAP))
    batches = -(-n_tiles // TILE_BATCH)
    enc, dec = 17, 13          # resnet34 BN->ReLU pairs; z_initial + 4 x (z_proj, bn1, bn2)
    # of a decode's 5 resizes, the logits' (one channel) takes the row kernel
    per_request = {"bn_relu": enc * (1 + batches) + dec * batches * N_SAMPLES,
                   "resize": 5 * batches * N_SAMPLES, "resize_row": batches * N_SAMPLES,
                   "reparam": 1, "normal": 0, "resize_bwd": 0, "conv_bn_stats": 0,
                   "conv_bn_stats_fp32": 0}
    expected = {k: v * N_REQUESTS for k, v in per_request.items()}
    expected["bn_relu"] += enc + dec        # one predict_image at 512^2
    expected["resize"] += 5
    expected["resize_row"] += 1
    expected["normal"] += 1
    return expected


def phase_slice(model) -> dict:
    g = torch.Generator(device="cuda").manual_seed(4)
    image = torch.rand((*IMAGE_HW, 3), device="cuda", generator=g)
    small = torch.rand((512, 512, 3), device="cuda", generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _ext.reset_launch_counts()
    for r in range(N_REQUESTS):
        t0 = time.perf_counter()
        samples, mu, logvar = segmentation_distribution(
            model, image, torch.Generator().manual_seed(100 + r), num_samples=N_SAMPLES,
            temperature=TEMPERATURE, patch_size=PATCH, tile_batch=TILE_BATCH, overlap=OVERLAP)
        maps = uncertainty_maps(samples)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(tuple(samples.shape) == (N_SAMPLES, *IMAGE_HW, 1), f"samples {samples.shape}")
        check(bool(torch.isfinite(samples).all()), "non-finite samples")
        check(bool(((samples >= 0) & (samples <= 1)).all()), "samples outside [0, 1]")
        check(tuple(mu.shape) == (32,) and bool(torch.isfinite(mu).all()), "mu")
        check(tuple(logvar.shape) == (32,) and bool(torch.isfinite(logvar).all()), "logvar")
        for k, v in maps.items():
            check(tuple(v.shape) == (*IMAGE_HW, 1) and bool(torch.isfinite(v).all()),
                  f"uncertainty map {k}")
        log(f"request {r}: {times[-1]:.3f} s  mean p {maps['mean'].mean().item():.4f}  "
            f"mean std {maps['std'].mean().item():.4f}  "
            f"sample spread {(samples[0] - samples[1]).abs().max().item():.4f}")
        del samples, maps
    probs, mask = predict_image(model, small, generator=torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    counts = _ext.launch_counts()
    check(tuple(probs.shape) == (512, 512, 1) and bool(torch.isfinite(probs).all()),
          "predict_image probs")
    check(mask.dtype == torch.bool and tuple(mask.shape) == (512, 512, 1), "predict_image mask")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = expected_launches()
    log(f"requests: p50 {statistics.median(times):.3f} s  max {max(times):.3f} s  "
        f"all {[round(t, 3) for t in times]}  (fp32, TF32 off)")
    log(f"peak memory: {peak:.2f} GiB")
    log(f"launches: {counts}  expected {expected}")
    for k in ("bn_relu", "resize", "resize_row", "reparam", "normal"):
        check(counts[k] > 0, f"kernel {k} was not launched on the serving path")
    check(counts == expected, f"launch counts {counts} differ from the code's {expected}")
    return counts


# ----- phase 5 -------------------------------------------------------------

def phase_parity(model) -> None:
    use_fp32_numerics()
    g = torch.Generator().manual_seed(6)
    image = torch.rand((512, 512, 3), generator=g)
    eps = torch.randn((2, 1, 32), generator=g)
    cpu_model = copy.deepcopy(model).to("cpu")
    gpu = segmentation_distribution(model, image, num_samples=2, eps=eps, device="cuda")
    cpu = segmentation_distribution(cpu_model, image, num_samples=2, eps=eps, device="cpu")
    errs = [(a.cpu() - b).abs().max().item() for a, b in zip(gpu, cpu)]
    log(f"card vs CPU at 512^2, N=2: samples {errs[0]:.3g}  mu {errs[1]:.3g}  "
        f"logvar {errs[2]:.3g}")
    check(errs[0] <= 2e-4, f"samples differ from the CPU by {errs[0]} > 2e-4")
    check(errs[1] <= 1e-4 and errs[2] <= 1e-4, f"mu/logvar differ from the CPU: {errs[1:]}")


# ----- phase 6 -------------------------------------------------------------

TRAIN_HW, TRAIN_BATCH = 512, 16
WARMUP_STEPS, TIMED_STEPS = 3, 10


def train_config(**kw) -> TrainConfig:
    """The step bench.py:42-51 times: resnet34, latent 32, 'all', attention
    skips, one class, 512^2, batch 16, bf16, no accumulation, lr 1e-4."""
    base = dict(model_type="resnet", batch_size=TRAIN_BATCH, gradient_accumulation_steps=1,
                amp=True, patch_size=TRAIN_HW, learning_rate=1e-4)
    base.update(kw)
    return TrainConfig(**base)


def launches(times: int = 1, **per_run) -> dict:
    """Every counter: `per_run` launches (0 where not named) `times` over."""
    return {k: per_run.get(k, 0) * times for k in _ext.launch_counts()}


def expected_train_launches(steps: int, amp: bool = True) -> dict:
    """Launches the training path's code implies: per forward, 29 encoder
    (stage sizes 3, 4, 6, 3: every block's conv2 and its stride-1 conv1) and
    8 decoder conv + BN pairs take the conv kernel, 4 decoder upsamples and
    the final one to 512^2 the resize kernel, whose backward runs as often,
    and the latent draw one noise kernel; eval BN+ReLU and the fused draw
    are not on this path.  The logits' resize takes the row kernel, and
    without `amp` every conv launch the fp32 kernel."""
    return launches(steps, conv_bn_stats=29 + 8, conv_bn_stats_fp32=0 if amp else 29 + 8,
                    resize=5, resize_row=1, resize_bwd=5, normal=1)


def first_step_moved_everything(model, before: dict) -> None:
    """Every parameter changed and is finite after one step.  The one
    allowed exception: a parameter whose gradient is exactly 0, which can
    only be a conv bias in front of a training BN (the BN subtracts the
    batch mean, so its gradient is 0 in exact arithmetic); a cut graph
    leaves .grad None and fails here."""
    still = []
    for name, p in model.named_parameters():
        check(p.grad is not None, f"{name}: no gradient (the graph was cut)")
        check(bool(torch.isfinite(p).all()), f"{name}: not finite after the step")
        if torch.equal(p.detach(), before[name]):
            still.append(name)
    for name in still:
        grad_zero = not bool(model.get_parameter(name).grad.any())
        check(grad_zero and name.endswith(".0.bias"),
              f"{name}: unchanged by the first step")
    log(f"first step: {sum(1 for _ in model.parameters())} parameter tensors, all finite; "
        f"unchanged: {still or 'none'}")


def phase_train() -> dict:
    config = train_config()
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), device="cuda", generator=g)
    masks = (torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1), device="cuda", generator=g)
             > 0.9).float()
    beta = 0.001
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    t0 = time.perf_counter()
    state, aux = step(state, images, masks, beta)
    torch.cuda.synchronize()
    log(f"train step 1 (cold): {time.perf_counter() - t0:.3f} s  loss {aux['loss'].item():.5f}")
    first_step_moved_everything(state.model, before)
    del before
    for _ in range(WARMUP_STEPS - 1):
        state, aux = step(state, images, masks, beta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, images, masks, beta)
        losses.append(aux["loss"].item())          # a host fetch, as bench.py ends a step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"losses {losses}")
    p50 = statistics.median(times)
    SUMMARY["bare_step_p50"] = p50
    img_s = TRAIN_BATCH * TIMED_STEPS / sum(times)
    log(f"train steps: p50 {p50:.4f} s  max {max(times):.4f} s  all "
        f"{[round(t, 4) for t in times]}  loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    log(f"train peak memory: {peak:.2f} GiB")
    log(json.dumps({"metric": "images_per_sec_per_chip_512sq_vaeunet_train_torch",
                    "value": round(img_s, 3), "unit": "img/s", "vs_baseline": None}))
    expected = expected_train_launches(TIMED_STEPS)
    log(f"train launches over {TIMED_STEPS} steps: {counts}  expected {expected}")
    for k in ("conv_bn_stats", "resize", "resize_row", "resize_bwd", "normal"):
        check(counts[k] > 0, f"kernel {k} was not launched on the training path")
    check(counts == expected, f"training launch counts {counts} differ from the code's {expected}")

    # one eval step: eval-mode BN through bn_relu, a sampled z, 12 valid rows
    eval_step = make_eval_step(config, state.model)
    valid = torch.tensor([1.0] * 12 + [0.0] * 4, device="cuda")
    _ext.reset_launch_counts()
    metrics, logits = eval_step(images, masks, torch.Generator().manual_seed(10), valid=valid)
    torch.cuda.synchronize()
    ecounts = _ext.launch_counts()
    check(tuple(logits.shape) == (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1)
          and bool(torch.isfinite(logits).all()), "eval logits")
    for k, v in metrics.items():
        check(0.0 <= v.item() <= 1.0, f"eval metric {k} = {v.item()}")
    expected_eval = {"bn_relu": 17 + 13, "resize": 5, "resize_row": 1, "normal": 1, "reparam": 0,
                     "resize_bwd": 0, "conv_bn_stats": 0, "conv_bn_stats_fp32": 0}
    log(f"eval step: {({k: round(v.item(), 5) for k, v in metrics.items()})}  launches {ecounts}")
    check(ecounts == expected_eval, f"eval launch counts {ecounts} differ from {expected_eval}")
    del state, step, eval_step, images, masks, logits
    torch.cuda.empty_cache()
    return counts


# ----- phase 7 -------------------------------------------------------------

FP32_WARMUP_STEPS, FP32_TIMED_STEPS = 2, 5


def phase_train_fp32() -> dict:
    """The step of phase 6 with ``amp=False`` and TF32 off, at full width:
    every conv + BN pair goes through the fp32 conv kernel."""
    use_fp32_numerics()
    config = train_config(amp=False)
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), device="cuda", generator=g)
    masks = (torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1), device="cuda", generator=g)
             > 0.9).float()
    for _ in range(FP32_WARMUP_STEPS):
        state, aux = step(state, images, masks, 0.001)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    times, losses = [], []
    for _ in range(FP32_TIMED_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, images, masks, 0.001)
        losses.append(aux["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"fp32 losses {losses}")
    img_s = TRAIN_BATCH * FP32_TIMED_STEPS / sum(times)
    log(f"fp32 train steps (amp=False, TF32 off): p50 {statistics.median(times):.4f} s  max "
        f"{max(times):.4f} s  all {[round(t, 4) for t in times]}  loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}")
    log(f"fp32 train peak memory: {peak:.2f} GiB")
    log(json.dumps({"metric": "images_per_sec_per_chip_512sq_vaeunet_train_torch_fp32",
                    "value": round(img_s, 3), "unit": "img/s", "vs_baseline": None}))
    expected = expected_train_launches(FP32_TIMED_STEPS, amp=False)
    log(f"fp32 train launches over {FP32_TIMED_STEPS} steps: {counts}  expected {expected}")
    check(counts["conv_bn_stats_fp32"] > 0, "the fp32 conv kernel was not launched")
    check(counts == expected, f"fp32 launch counts {counts} differ from the code's {expected}")
    del state, step, images, masks
    torch.cuda.empty_cache()
    return counts


# ----- phase 8 -------------------------------------------------------------

def phase_train_parity(label: str = "resnet34 VAE-UNet", **config_kw) -> None:
    """One fp32 step on the card and on the CPU from the same weights,
    batch and noise, 128^2, batch 2, accumulation 2.  Tolerances as in
    tests/torch_train_parity.py; the first Adam step is lr g / (|g| + eps),
    whose sign can flip where |g| is near 0, hence 2 lr on the parameters,
    plus 1e-6 for the fp32 rounding of p +- lr."""
    use_fp32_numerics()
    lr = 1e-4
    config = train_config(batch_size=2, gradient_accumulation_steps=2, amp=False,
                          patch_size=128, learning_rate=lr, **config_kw)
    g = torch.Generator().manual_seed(11)
    images = torch.rand((2, 128, 128, 3), generator=g)
    masks = (torch.rand((2, 128, 128, 1), generator=g) > 0.9).float()
    eps = torch.randn((2, 1, 32), generator=g) if config.model_type == "resnet" else None
    results = []
    for device in ("cuda", "cpu"):
        state = create_train_state(config, seed=3, device=device)
        state, aux = make_train_step(config, state.model)(state, images, masks, 0.001, eps=eps)
        results.append((aux["loss"].item(),
                        {k: v.detach().cpu() for k, v in state.model.state_dict().items()}))
        del state
    (loss_gpu, sd_gpu), (loss_cpu, sd_cpu) = results
    err_p = max((sd_gpu[k] - v).abs().max().item() for k, v in sd_cpu.items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    err_s = max(((sd_gpu[k] - v).abs() - 1e-3 * v.abs()).max().item()
                for k, v in sd_cpu.items() if k.endswith(("running_mean", "running_var")))
    log(f"train parity, {label}, card vs CPU, fp32 128^2 b2 accum 2: loss {loss_gpu:.7f} vs "
        f"{loss_cpu:.7f}  params max err {err_p:.3g} (2 lr = {2 * lr:g})  running stats "
        f"max err beyond 1e-3 |ref| {err_s:.3g}")
    check(abs(loss_gpu - loss_cpu) <= 1e-5, f"{label}: loss differs from the CPU by "
          f"{loss_gpu - loss_cpu}")
    check(err_p <= 2 * lr + 1e-6, f"{label}: parameters differ from the CPU by {err_p} > 2 lr")
    check(err_s <= 1e-4, f"{label}: running statistics differ from the CPU beyond "
          f"1e-4 + 1e-3 |ref|")
    torch.cuda.empty_cache()


# ----- phase 9 -------------------------------------------------------------

UNET_SCALED_HW = (1424, 2144)    # the fundus at predict.py's default --scale 0.5


def phase_unet_serve() -> dict:
    """The request of the top-level predict.py (``predict.py:45-61``) with
    the model it builds by default, ``UNet(3, 1, bilinear=False)``: the
    image already at --scale 0.5, ``predict_image``, the probabilities
    resized back to 2848x4288 (align_corners=False, the row kernel), the
    threshold.  Then the card against the CPU at 3x256x256, both
    ``bilinear`` settings: logits atol 5e-4, masks equal except where
    |p - 0.5| < 1e-4."""
    use_fp32_numerics()
    model = build_unet(3, 1, bilinear=False, seed=0, device="cuda")
    randomize_bn_stats(model, seed=1)
    g = torch.Generator(device="cuda").manual_seed(14)
    scaled = torch.rand((*UNET_SCALED_HW, 3), device="cuda", generator=g)
    predict_image(model, scaled)                    # cuDNN's plans for these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    times = []
    for r in range(N_REQUESTS):
        t0 = time.perf_counter()
        probs, _ = predict_image(model, scaled)
        full = resize_bilinear(probs[None].permute(0, 3, 1, 2), IMAGE_HW, align_corners=False)
        mask = full[0, 0] > 0.5
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(tuple(full.shape) == (1, 1, *IMAGE_HW) and bool(torch.isfinite(full).all())
              and bool(((full >= 0) & (full <= 1)).all()), "UNet request probabilities")
        check(mask.dtype == torch.bool and tuple(mask.shape) == IMAGE_HW, "UNet request mask")
        log(f"UNet request {r}: {times[-1]:.3f} s  mask share {mask.float().mean().item():.4f}")
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = launches(N_REQUESTS, bn_relu=18, resize=1, resize_row=1)
    log(f"UNet requests ({list(UNET_SCALED_HW)} in, {list(IMAGE_HW)} out): p50 "
        f"{statistics.median(times):.3f} s  max {max(times):.3f} s  all "
        f"{[round(t, 3) for t in times]}  peak memory {peak:.2f} GiB  (fp32, TF32 off)")
    log(f"UNet request launches: {counts}  expected {expected}")
    check(counts == expected, f"UNet request launch counts {counts} differ from {expected}")
    for bilinear in (False, True):
        card = model if not bilinear else build_unet(3, 1, bilinear=True, seed=0, device="cuda")
        if bilinear:
            randomize_bn_stats(card, seed=1)
        cpu = copy.deepcopy(card).to("cpu")
        image = torch.rand((256, 256, 3), generator=torch.Generator().manual_seed(15))
        with torch.inference_mode():
            lg = card(to_nchw(image.cuda()[None])).cpu()
            lc = cpu(to_nchw(image[None]))
        pg, mg = predict_image(card, image)
        pc, mc = predict_image(cpu, image, device="cpu")
        err = (lg - lc).abs().max().item()
        flips = (mg.cpu() != mc)
        log(f"UNet bilinear={bilinear} card vs CPU at 3x256x256: logits {err:.3g}  "
            f"mask flips {int(flips.sum())}")
        check(err <= 5e-4, f"UNet bilinear={bilinear}: logits differ from the CPU by {err}")
        check(bool(((pc[flips] - 0.5).abs() < 1e-4).all()),
              f"UNet bilinear={bilinear}: a mask pixel flips away from p = 0.5")
        del card, cpu
    del model, scaled, probs, full
    torch.cuda.empty_cache()
    return counts


# ----- phases 10 and 11 ----------------------------------------------------

NEW_WARMUP_STEPS, NEW_TIMED_STEPS = 3, 5


def train_path(config: TrainConfig, label: str, per_step: dict) -> tuple:
    """The 512^2 batch-16 step of `config`: the first step moves every
    parameter and leaves it finite; 3 warm and 5 timed steps, whose launch
    counts must equal `per_step` x 5.  -> (state, counts, images, masks)."""
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), device="cuda", generator=g)
    masks = (torch.rand((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1), device="cuda", generator=g)
             > 0.9).float()
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    t0 = time.perf_counter()
    state, aux = step(state, images, masks, 0.001)
    torch.cuda.synchronize()
    log(f"{label} step 1 (cold): {time.perf_counter() - t0:.3f} s  loss {aux['loss'].item():.5f}")
    first_step_moved_everything(state.model, before)
    del before
    for _ in range(NEW_WARMUP_STEPS - 1):
        state, aux = step(state, images, masks, 0.001)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    times, losses = [], []
    for _ in range(NEW_TIMED_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, images, masks, 0.001)
        losses.append(aux["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"{label} losses {losses}")
    log(f"{label} train steps: p50 {statistics.median(times):.4f} s  max {max(times):.4f} s  "
        f"all {[round(t, 4) for t in times]}  "
        f"{TRAIN_BATCH * NEW_TIMED_STEPS / sum(times):.1f} img/s  peak memory {peak:.2f} GiB  "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    expected = launches(NEW_TIMED_STEPS, **per_step)
    log(f"{label} launches over {NEW_TIMED_STEPS} steps: {counts}  expected {expected}")
    check(counts == expected, f"{label} launch counts {counts} differ from the code's {expected}")
    return state, counts, images, masks


def phase_unet_train() -> list:
    """The bench.py step settings on the plain UNet, both ``bilinear``
    settings: 18 conv-kernel launches a step, and with ``bilinear`` 4
    resizes forward and 4 backward; one eval step (18 ``bn_relu``); then one
    fp32 step card vs CPU at 128^2."""
    out = []
    for bilinear in (False, True):
        config = train_config(model_type="basic", bilinear=bilinear)
        label = f"UNet bilinear={bilinear}"
        up = 4 if bilinear else 0
        state, counts, images, masks = train_path(
            config, label, dict(conv_bn_stats=18, resize=up, resize_bwd=up))
        out.append(counts)
        _ext.reset_launch_counts()
        metrics, logits = make_eval_step(config, state.model)(images, masks)
        torch.cuda.synchronize()
        ecounts = _ext.launch_counts()
        check(tuple(logits.shape) == (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1)
              and bool(torch.isfinite(logits).all()), f"{label} eval logits")
        expected = launches(bn_relu=18, resize=up)
        log(f"{label} eval step: {({k: round(v.item(), 5) for k, v in metrics.items()})}  "
            f"launches {ecounts}")
        check(ecounts == expected, f"{label} eval launch counts {ecounts} differ from {expected}")
        del state, images, masks, logits
        torch.cuda.empty_cache()
        phase_train_parity(label, model_type="basic", bilinear=bilinear)
    return out


def phase_r50_train() -> dict:
    """The bench.py step settings on the resnet50 VAE-UNet ('all',
    attention skips) with deep supervision: 21 conv-kernel launches a step;
    resizes: the decoder's 4 and the logits' 1, forward and backward, and
    the masks' 3 downsamples for the heads (one channel, the row kernel);
    one noise draw.  Then one fp32 step card vs CPU at 128^2."""
    config = train_config(backbone="resnet50", deep_supervision=True)
    state, counts, _, _ = train_path(
        config, "resnet50 VAE-UNet + deep supervision",
        dict(conv_bn_stats=21, resize=5 + 3, resize_row=1 + 3, resize_bwd=5, normal=1))
    del state
    torch.cuda.empty_cache()
    phase_train_parity("resnet50 VAE-UNet + deep supervision", backbone="resnet50",
                       deep_supervision=True)
    return counts


# ----- phase 12 ------------------------------------------------------------

def phase_remat() -> dict:
    """One fp32 resnet34 VAE-UNet step (TF32 off, 256^2, batch 4, the same
    weights, batch and noise) without remat, with 'full' and with
    'save_convs': loss and BN running statistics equal (atol 1e-6), the
    gradient within relative L2 1e-5, ``num_batches_tracked`` 1 after the
    step; 'full' recomputes all 37 kernel convs, 'save_convs' none; 'full'
    holds less memory than no remat, at its peak and after the forward
    (where 'save_convs' lies between the two)."""
    use_fp32_numerics()
    g = torch.Generator(device="cuda").manual_seed(13)
    images = torch.rand((4, 256, 256, 3), device="cuda", generator=g)
    masks = (torch.rand((4, 256, 256, 1), device="cuda", generator=g) > 0.9).float()
    eps = torch.randn((1, 4, 32), device="cuda", generator=g)
    runs, total = {}, launches()
    for policy in ("none", "full", "save_convs"):
        config = train_config(amp=False, batch_size=4, patch_size=256,
                              use_remat=policy != "none",
                              remat_policy="full" if policy == "none" else policy)
        state = create_train_state(config, seed=0, device="cuda")
        step = make_train_step(config, state.model)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        aux = step.compute_gradients(state, images, masks, 0.001, eps=eps)
        torch.cuda.synchronize()
        counts = _ext.launch_counts()
        total = {k: total[k] + counts[k] for k in total}
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        model = state.model
        runs[policy] = dict(
            loss=aux["loss"].item(), peak=peak, counts=counts,
            grads={k: p.grad.detach().clone() for k, p in model.named_parameters()},
            stats={k: v.clone() for k, v in model.state_dict().items() if "running_" in k},
            tracked={int(v) for k, v in model.state_dict().items()
                     if k.endswith("num_batches_tracked")})
        # what the forward leaves for the backward: the memory remat cuts
        model.zero_grad(set_to_none=True)
        x = to_model_layout(images, images.device)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss, _ = forward_loss(model, make_criterion(config.lesion_type, config.loss), config, x,
                               masks, 0.001, eps=eps[0])
        runs[policy]["held"] = (torch.cuda.memory_allocated() - before) / 2 ** 30
        del loss, _, x
        log(f"remat {policy}: loss {runs[policy]['loss']:.7f}  peak memory above the weights "
            f"{peak:.3f} GiB  held after the forward {runs[policy]['held']:.3f} GiB  "
            f"launches {counts}")
        del state, step, model, aux
        torch.cuda.empty_cache()
    base = runs["none"]
    check(base["counts"]["conv_bn_stats"] == 37, "remat none: conv launches")
    for policy, conv_launches in (("full", 74), ("save_convs", 37)):
        r = runs[policy]
        ours = torch.cat([r["grads"][k].flatten() for k in base["grads"]])
        theirs = torch.cat([v.flatten() for v in base["grads"].values()])
        rel = ((ours - theirs).norm() / theirs.norm()).item()
        stats_err = max((r["stats"][k] - v).abs().max().item() for k, v in base["stats"].items())
        log(f"remat {policy} vs none: loss {r['loss'] - base['loss']:.3g}  running stats "
            f"{stats_err:.3g}  gradient relative L2 {rel:.3g}  peak memory {r['peak']:.3f} vs "
            f"{base['peak']:.3f} GiB  held after the forward {r['held']:.3f} vs "
            f"{base['held']:.3f} GiB")
        check(abs(r["loss"] - base["loss"]) <= 1e-6, f"remat {policy}: loss differs")
        check(stats_err <= 1e-6, f"remat {policy}: running statistics differ by {stats_err}")
        check(rel <= 1e-5, f"remat {policy}: gradient differs by {rel} (relative L2)")
        check(r["tracked"] == {1}, f"remat {policy}: num_batches_tracked {r['tracked']}")
        check(r["counts"]["conv_bn_stats"] == conv_launches,
              f"remat {policy}: {r['counts']['conv_bn_stats']} conv launches, "
              f"expected {conv_launches}")
    check(base["tracked"] == {1}, f"remat none: num_batches_tracked {base['tracked']}")
    check(runs["full"]["peak"] < base["peak"], "remat full holds no less memory than none")
    check(runs["full"]["held"] < runs["save_convs"]["held"] < base["held"],
          "the forward's saved activations do not shrink from none to save_convs to full")
    return total


# ----- phase 13 ------------------------------------------------------------

FUNDUS_SPLITS = (("train", 4), ("val", 2))
LOOP_SCALE, LOOP_EPOCHS = 0.5, 2
TRAIN_STEP_LAUNCHES = dict(conv_bn_stats=37, resize=5, resize_row=1, resize_bwd=5, normal=2)
EVAL_STEP_LAUNCHES = dict(bn_relu=17 + 13, resize=5, resize_row=1, normal=1)


def write_fundus_set(root: Path, seed: int) -> None:
    """IDRiD's layout at IDRiD's 2848x4288: JPG fundus images (a bright disk
    cut at top and bottom, as IDRiD's are, with yellow exudate blobs) and
    their EX masks as TIFs, from `seed`."""
    rng = np.random.RandomState(seed)
    h, w = IMAGE_HW
    yy, xx = np.ogrid[:h, :w]
    disk = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.6 * h) ** 2
    for split, n in FUNDUS_SPLITS:
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            img = np.zeros((h, w, 3), np.uint8)
            img[disk] = (rng.randint(-20, 21, (int(disk.sum()), 3))
                         + np.array([150, 70, 30])).clip(0, 255)
            mask = np.zeros((h, w), np.uint8)
            for _ in range(120):
                cy = rng.randint(h // 14, h - h // 14)
                cx = rng.randint(w // 5, w - w // 5)
                r = rng.randint(max(2, h // 285), h // 47)
                y0, x0 = cy - r, cx - r
                by, bx = np.ogrid[-r:r + 1, -r:r + 1]
                blob = (by ** 2 + bx ** 2 <= r * r) & disk[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1]
                img[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1][blob] = (230, 210, 90)
                mask[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1][blob] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg", quality=90)
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")


def loop_config(root: Path, **kw) -> TrainConfig:
    """The flagship at full width (bench.py:42-51's model and step): resnet34
    VAE-UNet, latent 32, 'all', attention skips, bf16; --scale 0.5
    --patch-size 512 --batch-size 16, accumulation 1, lr 1e-4, beta 0.001;
    2 epochs with kl_anneal_epochs=2; device cache and augmentation on."""
    base = dict(img_scale=LOOP_SCALE, epochs=LOOP_EPOCHS, kl_anneal_epochs=LOOP_EPOCHS,
                beta=0.001, data_dir=str(root / "idrid"), lesion_type="EX", seed=0,
                checkpoint_dir=str(root / "ckpt"))
    base.update(kw)
    return train_config(**base)


def augment_checks(images: torch.Tensor, masks: torch.Tensor) -> None:
    """Each transform on the card against the CPU at the same parameters:
    flips, rot90 and masks exact; affine within 2^-7 at <= 0.1 % of the
    values; gamma, colour, noise, blur, grid within 1e-6; CLAHE within 1e-5
    except a bf16 flip of a LUT entry (<= 2^-8 x image / luma, <= 0.1 %).
    The tolerances of tests/test_torch_augment.py."""
    gen = torch.Generator().manual_seed(17)
    p_cpu = augment.draw_params(gen, images.shape[0])
    for k in ("contrast", "color", "affine", "noise", "blur", "grid"):
        p_cpu[k] = torch.ones_like(p_cpu[k])             # every sample applies each transform
    p_gpu = augment.params_to(p_cpu, "cuda")
    p_cpu = augment.params_to(p_cpu, "cpu")
    eps = reparam_mod.normal(images.shape, 5, "cuda")
    cases = {
        "flips": (lambda p, x, m, e: augment.apply_flips(x, m, p["do_h"], p["do_v"], p["rot_k"]),
                  0.0),
        "contrast": (lambda p, x, m, e: augment.apply_contrast(
            x, p["contrast"], p["use_clahe"], p["clip"], p["gamma"]), None),
        "color": (lambda p, x, m, e: augment.apply_color(
            x, p["color"], p["use_bc"], p["alpha"], p["beta"], p["jit_b"], p["jit_c"],
            p["jit_s"]), 1e-6),
        "affine": (lambda p, x, m, e: augment.apply_affine(
            x, m, p["affine"], p["scale"], p["tx"], p["ty"], p["theta"]), 2.0 ** -7),
        "noise": (lambda p, x, m, e: augment.apply_noise(x, p["noise"], p["var"], e), 1e-6),
        "blur": (lambda p, x, m, e: augment.apply_blur(
            x, p["blur"], p["use_gauss"], p["use5"], p["direction"]), 1e-6),
        "grid": (lambda p, x, m, e: augment.apply_grid(x, m, p["grid"], p["grid_x"],
                                                       p["grid_y"]), 1e-6),
    }
    x_cpu, m_cpu, e_cpu = images.cpu(), masks.cpu(), eps.cpu()
    for name, (fn, atol) in cases.items():
        gpu = fn(p_gpu, images, masks, eps)
        cpu = fn(p_cpu, x_cpu, m_cpu, e_cpu)
        gpu, cpu = (gpu, cpu) if isinstance(gpu, tuple) else ((gpu,), (cpu,))
        check(torch.equal(gpu[1].cpu(), cpu[1]) if len(gpu) > 1 else True,
              f"augment {name}: masks differ between the card and the CPU")
        diff = (gpu[0].cpu() - cpu[0]).abs()
        if name == "contrast":
            lum = 0.299 * x_cpu[..., 0] + 0.587 * x_cpu[..., 1] + 0.114 * x_cpu[..., 2]
            room = 1e-5 + 2.0 ** -8 * x_cpu / lum.clamp(min=1e-6).unsqueeze(-1)
            ok = bool((diff <= room).all()) and (diff > 1e-5).float().mean().item() <= 1e-3
        elif name == "affine":
            ok = diff.max().item() <= atol and (diff > 0).float().mean().item() <= 1e-3
        else:
            ok = diff.max().item() <= atol
        log(f"augment {name} card vs CPU [16,512,512,3]: max err {diff.max().item():.3g}  "
            f"values off {(diff > 0).float().mean().item():.2e}")
        check(ok, f"augment {name}: card and CPU differ beyond the tolerance")


def loop_launches(report: dict, val_batches: int) -> dict:
    steps, validations = len(report["step_times"]), len(report["val_times"])
    per_train, per_eval = launches(steps, **TRAIN_STEP_LAUNCHES), launches(
        validations * val_batches, **EVAL_STEP_LAUNCHES)
    return {k: per_train[k] + per_eval[k] for k in per_train}


def run_loop(label: str, config: TrainConfig, datasets, root: Path, **kw) -> tuple:
    """train_model with its launch counts held and its numbers printed."""
    train_ds, val_ds = datasets
    tracker = Tracker(run_dir=str(root / "runs" / label.replace(" ", "_")))
    report: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    state = train_model(config, tracker=tracker, train_dataset=train_ds, val_dataset=val_ds,
                        device="cuda", report=report, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    val_batches = -(-len(val_ds) // config.batch_size)
    expected = loop_launches(report, val_batches)
    times = report["step_times"]
    warm = times[1:] or times
    losses = [json.loads(line)["train/total_loss"]
              for line in (tracker.run_dir / "metrics.jsonl").read_text().splitlines()
              if "train/total_loss" in line]
    log(f"{label}: {wall:.1f} s, epochs {report['start_epoch']}-{config.epochs}, "
        f"{report['steps_per_epoch']} steps an epoch, {len(times)} steps, "
        f"{len(report['val_times'])} validations of {val_batches} batches")
    log(f"{label} steps (host clock, end to end of consecutive steps, no sync a step): p50 "
        f"{statistics.median(warm):.4f} s  max {max(warm):.4f} s  cold first "
        f"{times[0]:.3f} s  ({config.batch_size * len(warm) / sum(warm):.1f} img/s)")
    log(f"{label} validations (each ends in its metrics' fetch): "
        f"{[round(v, 3) for v in report['val_times']]} s  peak memory {peak:.2f} GiB")
    log(f"{label} losses: {[round(v, 4) for v in losses]}")
    log(f"{label} launches: {counts}  expected {expected}")
    check(len(losses) == len(times) and all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(counts == expected, f"{label}: launch counts {counts} differ from the code's {expected}")
    return state, report, counts, tracker


def phase_loop() -> dict:
    """The training loop through ``train_model`` on a synthetic IDRiD set
    at IDRiD's own size: the flagship at full width, the image-level device
    cache and the augmentation on, 2 epochs; then a resume from ``best``
    for one more epoch; then one epoch host-fed (no device cache, the
    pinned copies).  -> the launch counts of the three runs."""
    os.environ["WANDB_MODE"] = "disabled"       # the tracker stays offline
    native.require()
    total = launches()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_fundus_set(root / "idrid", seed=21)
        log(f"loop data: {sum(n for _, n in FUNDUS_SPLITS)} fundus JPGs + EX TIFs at "
            f"{IMAGE_HW[0]}x{IMAGE_HW[1]} written in {time.perf_counter() - t0:.1f} s")
        config = loop_config(root)
        t0 = time.perf_counter()
        kw = dict(scale=LOOP_SCALE, patch_size=TRAIN_HW, lesion_type="EX",
                  cache_dir=str(root / "cache"))
        train_ds = IDRIDDataset(config.data_dir, split="train", balance_seed=config.seed, **kw)
        val_ds = IDRIDDataset(config.data_dir, split="val", **kw)
        log(f"dataset build (decode, scale {LOOP_SCALE}, patch index, uint8 cache): "
            f"{time.perf_counter() - t0:.1f} s; train {len(train_ds)} patches "
            f"({sum(r[3] for r in train_ds.patch_index)} with lesions), val {len(val_ds)}; "
            f"native host ops: {native.available()}")
        check(len(train_ds) >= 2 * TRAIN_BATCH, f"train set of {len(train_ds)} patches")

        # one batch of the image cache = the host loader's (the native gather)
        cache = ImageDeviceCache(train_ds, "cuda")
        idx = np.random.RandomState(0).permutation(len(train_ds))[:TRAIN_BATCH]
        images, masks = cache.make_gather()(
            cache.images, cache.masks, torch.as_tensor(cache.batch_indices(idx), device="cuda"))
        host = train_ds.gather_batch(idx)
        check(torch.equal(images.cpu(), torch.from_numpy(host["image"]))
              and torch.equal(masks.cpu(), torch.from_numpy(host["mask"])),
              "a batch gathered from ImageDeviceCache differs from the host loader's")
        log(f"image cache batch == host loader batch, bit for bit ({TRAIN_BATCH} patches)")
        augment_checks(images, masks)
        gen = torch.Generator().manual_seed(3)
        aug_ms = time_ms(lambda: augment.augment_batch(gen, images, masks), 10)
        rec = torch.as_tensor(cache.batch_indices(idx), device="cuda")
        gather_ms = time_ms(lambda: cache.make_gather()(cache.images, cache.masks, rec), 20)
        log(f"on the card, [16,512,512,3]: gather {gather_ms:.3f} ms  augment_batch "
            f"{aug_ms:.3f} ms (CUDA events; phase 6's bare step p50 "
            f"{SUMMARY.get('bare_step_p50', float('nan')):.4f} s)")

        # the indexed, augmented step: a finite loss, every parameter moves
        state = create_train_state(config, seed=0, device="cuda")
        step = make_train_step(config, state.model, augment=True, indexed=True,
                               gather=cache.make_gather())
        before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
        state, aux = step(state, cache.images, cache.masks, cache.batch_indices(idx), 0.001)
        check(bool(torch.isfinite(aux["loss"])), f"indexed augmented step: loss {aux['loss']}")
        first_step_moved_everything(state.model, before)
        del state, step, before, cache, images, masks, rec
        torch.cuda.empty_cache()

        datasets = (train_ds, val_ds)
        state, report, counts, _ = run_loop("loop", config, datasets, root)
        check(isinstance(report["device_train"], ImageDeviceCache)
              and isinstance(report["device_val"], ImageDeviceCache),
              f"the loop chose {type(report['device_train']).__name__}, not ImageDeviceCache")
        cache_bytes = report["device_train"].nbytes + report["device_val"].nbytes
        est_image = estimate_image_bytes(train_ds) + estimate_image_bytes(val_ds)
        est_patch = estimate_bytes(train_ds) + estimate_bytes(val_ds)
        log(f"device cache: ImageDeviceCache, {cache_bytes / 2 ** 20:.1f} MiB uint8 (estimate "
            f"{est_image / 2 ** 20:.1f}; the patch layout would take {est_patch / 2 ** 20:.1f})")
        total = {k: total[k] + counts[k] for k in total}

        # the state round-trips through a checkpoint on the card, bit for bit
        check_dir = str(root / "round_trip")
        save_checkpoint(check_dir, state, config, name="round_trip")
        fresh = create_train_state(config, seed=1, device="cuda")
        fresh, _ = restore_checkpoint(check_dir, fresh, name="round_trip")
        sa, sb = state.model.state_dict(), fresh.model.state_dict()
        oa, ob = state.optimizer.state_dict()["adamw"], fresh.optimizer.state_dict()["adamw"]
        same = (all(torch.equal(sa[k], sb[k]) for k in sa)
                and all(torch.equal(v, ob["state"][i][k]) for i, st in oa["state"].items()
                        for k, v in st.items())
                and torch.equal(state.generator.get_state(), fresh.generator.get_state())
                and state.step == fresh.step)
        check(same, "the restored state differs from the saved one")
        log(f"checkpoint round trip: {len(sa)} model tensors (with BN buffers), "
            f"{sum(len(st) for st in oa['state'].values())} AdamW tensors, the generator "
            f"and step {state.step}: equal, bit for bit")
        del state, fresh, report
        torch.cuda.empty_cache()

        # resume from best for one more epoch
        run_dir = config.checkpoint_path()
        saved = json.loads((Path(run_dir) / "host_state.json").read_text())
        resume_config = loop_config(root, epochs=saved["epoch"] + 1)
        state, report, counts, _ = run_loop("resumed loop", resume_config, datasets, root,
                                            resume_from=run_dir)
        check(report["start_epoch"] == saved["epoch"] + 1,
              f"resumed at epoch {report['start_epoch']}, saved epoch {saved['epoch']}")
        total = {k: total[k] + counts[k] for k in total}
        del state, report
        torch.cuda.empty_cache()

        # host-fed: no device cache, pinned copies
        host_config = loop_config(root, epochs=1, device_cache=False,
                                  checkpoint_dir=str(root / "ckpt_host"))
        state, report, counts, _ = run_loop("host-fed loop", host_config, datasets, root)
        check(report["device_train"] is None, "the host-fed run used a device cache")
        total = {k: total[k] + counts[k] for k in total}
        del state, report
        torch.cuda.empty_cache()
    return total


KERNELS = (
    ("normal", "vaeunet_tpu_torch/csrc/reparam.cu", "vaeunet_tpu/ops/pallas/reparam.py:54"),
    ("reparam", "vaeunet_tpu_torch/csrc/reparam.cu", "vaeunet_tpu/ops/pallas/reparam.py:87"),
    ("bn_relu", "vaeunet_tpu_torch/csrc/bn_relu.cu", "vaeunet_tpu/ops/pallas/bn_relu.py:30"),
    ("resize", "vaeunet_tpu_torch/csrc/resize.cu", "vaeunet_tpu/ops/pallas/resize_mm.py:70,98"),
    ("resize_bwd", "vaeunet_tpu_torch/csrc/resize.cu",
     "vaeunet_tpu/ops/pallas/resize_mm.py:125-151"),
    ("conv_bn_stats", "vaeunet_tpu_torch/csrc/conv_bn_stats.cu",
     "vaeunet_tpu/ops/pallas/conv_bn_stats.py:112"),
    # the fp32 kernel of the same wrapper, and the one-channel kernel of the resize's
    ("conv_bn_stats_fp32", "vaeunet_tpu_torch/csrc/conv_bn_stats.cu",
     "vaeunet_tpu/ops/pallas/conv_bn_stats.py:112"),
    ("resize_c1", "vaeunet_tpu_torch/csrc/resize.cu", "vaeunet_tpu/ops/pallas/resize_mm.py:70,98"),
)
# entry of the kernels line -> its launch counter where the names differ
COUNTERS = {"resize_c1": "resize_row"}
# wrapper -> the counter of its second kernel, whose launches it also counts
OTHER_KERNEL = {"resize": "resize_row", "conv_bn_stats": "conv_bn_stats_fp32"}


def path_launches(name: str, *phases: dict) -> int:
    """Launches of one entry's kernel over the paths' phases: a wrapper's
    count less those that took its other kernel."""
    other = OTHER_KERNEL.get(name)
    return sum(c[COUNTERS.get(name, name)] - (c[other] if other else 0) for c in phases)


def main() -> None:
    t_start = time.perf_counter()
    device = phase_device()
    use_fp32_numerics()
    phase_build()
    table = phase_kernels()
    log(f"phases 1-3: {time.perf_counter() - t_start:.1f} s")
    model = build_model(backbone="resnet34", latent_dim=32, latent_injection="all",
                        seed=0, device="cuda")
    randomize_bn_stats(model, seed=1)
    counts = phase_slice(model)
    phase_parity(model)
    del model
    torch.cuda.empty_cache()
    train_counts = phase_train()
    fp32_counts = phase_train_fp32()
    phase_train_parity()
    log(f"phases 4-8: {time.perf_counter() - t_start:.1f} s")
    path_counts = [counts, train_counts, fp32_counts, phase_unet_serve(), *phase_unet_train(),
                   phase_r50_train(), phase_remat()]
    log(f"phases 9-12: {time.perf_counter() - t_start:.1f} s")
    path_counts.append(phase_loop())
    kernels = []
    for name, source, replaces in KERNELS:
        rec = table[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path_launches(name, *path_counts),
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"], "shape": rec["shape"],
                        **({"augmentation_shape": rec["augmentation_shape"]}
                           if "augmentation_shape" in rec else {}),
                        **({"wrapper_ms": rec["wrapper_ms"]} if "wrapper_ms" in rec else {})})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
