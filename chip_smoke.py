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
   and per step; at the one-channel logits resize and its gradient the row
   kernels, the scalar kernels and the plain versions bit for bit, the
   gradient's launch alone timed beside the scalar kernel's and
   upsample_bilinear2d_backward; ``bn_relu`` (the fold inside the kernel)
   at the twelve shapes of the request in fp32 and of the eval step in
   bf16, through the wrapper and the launch alone beside F.batch_norm +
   relu_, with each path's sum of launches x ms against its bound and the
   shapes at which the kernel is slower than the library call; the
   training BN + ReLU kernels at the two training cells' widest sites
   (forward bit for bit with the plain version, running statistics
   included; backward repeated bit for bit and within a bf16 ulp of the
   closed form), beside training ``F.batch_norm`` + relu and its backward;
   the optimizer step's two kernels (clip by global norm, then AdamW) at the
   three training configurations' parameter sets, one step bit for bit with
   ``clip_`` + torch's AdamW, timed beside that path and torch's fused
   AdamW after ``clip_``;
4. the slice: the full-width resnet34 VAE-UNet (random weights from a seed,
   randomized BN statistics) answers 3 uncertainty requests on a 2848x4288
   image, 512 tiles with overlap 100, N=10 samples at T=1, plus one sampled
   ``predict_image`` at 512^2.  Kernel launch counts are read over exactly
   this phase and held against the counts the code implies;
5. the card's slice against the CPU's on one 512^2 image, same weights and
   noise, TF32 off: samples atol 2e-4, mu/logvar atol 1e-4;
6. training: the flagship VAE-UNet (random weights from a seed) at 512^2,
   batch 16, bf16, no accumulation: the first step must change every
   parameter and leave it finite, then 3 warm-up and 10 counted steps, whose
   kernel launch counts are held against the counts the code implies, and
   one eval step on 16 images with a ``valid`` row mask;
7. the same step in fp32 (``amp=False``, TF32 off) at full width: 2 warm
   and 5 counted steps with their launch counts and peak memory;
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
   every parameter moves, 3 warm and 5 counted steps with their launch
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
   loop's launches equal 37 conv, 5 resize (1 row), 5 resize backward (1
   row) and 2 noise draws a train step plus 30 bn_relu, 5 resize (1 row) and 1 noise
   draw an eval step; a checkpoint round trip is exact; a resume from
   ``best`` runs one more epoch from the saved epoch + 1; one epoch runs
   host-fed (no cache, pinned copies);
14. the analysis path through its CLIs, on phase 13's temporary tree (which
   ``main`` holds) with a test split of 2 fundi at 2848x4288 added from a
   seed: phase 13's ``best`` run dir and the same weights saved as a
   reference-format .pth load alike (``compat.load_model``: equal state
   dicts, logits within 1e-6); ``cli.analyze`` (analyze_model.py's request:
   --scale 1.0, tiles 512/100, N=10, T=1, tile batch 4, --extended-metrics,
   the global plots) on one fundus, whose 13-column CSV must be finite, the
   6 global PNGs present and the spill dir gone; ``fused_probability`` of
   one fundus at scales 1.0 and 0.5 (max fusion at least each member's
   mean, an expected-area threshold in (0, 1]); ``cli.visualize`` at
   --scale 0.5 (3 PNGs); ``cli.evaluate`` on the val split at --scale 0.5,
   patches of 512 (finite metrics); ``cli.predict`` with a plain-UNet .pth
   on a fundus PNG (a 2848x4288 mask equal to predict_image + resize +
   threshold on the same weights).  Each step's launches are held to the
   code's, and the request's, the host metrics' and the global stage's
   times printed beside the card's name and power limit;
15. parallelism (``parallel/``), each rank a process of ``parallel.launch``:
   (a) one rank over NCCL, where the flagship's global-batch DP step (bf16,
   512^2, batch 16) equals ``make_train_step``'s on the same weights, batch
   and generator bit for bit, its launches held; (b) two ranks over gloo
   sharing the card (NCCL with a card each): the fp32 DP step (TF32 off,
   global batch 16) against the one-rank step, the per-device step
   (``explicit=True``) against its hand split, the channel-sharded step
   (model axis 2, ``min_channels`` 256, batch 4) against the unsharded one,
   all within tests/torch_train_parity.py's bounds, and its clip norm
   against the gathered gradient's; the plain UNet's TP gradient (its
   transposed convs row-parallel) against the unsharded model's whose
   transposed convs sum their input-channel halves as the ranks do;
   ``ensemble_sample_parallel`` (N=10, 1024^2) against the one-rank decode and ``predict_tiled_sharded`` of a
   2848x4288 image against ``predict_with_patches``, atol 1e-5; the ranks'
   step launches held;
16. encoder pretraining and the profiling helpers: the masked and the
   contrastive pretext at full width (resnet34, 512^2, batch 8, bf16), 3
   steps each (every parameter moved and finite, launches held);
   ``time_fn``, ``trace`` and ``track_memory`` once each on the masked
   step (the traced step's ``bn_batch_fwd`` and ``bn_batch_bytes`` held to
   the BN modules' training calls and their inputs' bytes, ``bn_torch``
   to 0); ``cli.pretrain`` for one epoch on phase 13's set, and ``cli.train
   --pretrained-encoder`` starting from its encoder bit for bit;
17. the ensemble protocol's tools, the offline sweep and the benchmark
   entry points, on phase 13's tree (its val split and phase 14's test
   split, 2 fundi each): ``cli.member_maps`` with phase 13's run dir at
   scale 0.5 and phase 14's .pth of the same weights at 1.0 with the h-flip
   (N=10, T=1, tiles 512) on both splits, every file present and finite,
   mom[0] / N the map within 1e-6, a second call writing nothing, the
   launches held; one fundus at 0.25 and T = 0 on the card against the CPU
   (atol 2e-4; its launches held); ``cli.tune_fusion`` greedy on the val
   maps and its point frozen onto the test maps (finite CSV rows);
   ``cli.scale_ensemble`` of the two members with the 7-column CSV and the
   11-weight mixing sweep (launches held); ``cli.sweep``, 2 one-epoch
   trials, both ``ok``; ``cli.bench`` and ``cli.bench_tiled`` at their
   defaults, their JSON lines printed and their launches held.  Each
   stage's time is printed beside the card's name and power limit.

Phase 3 also holds the conv kernel in both types at every conv shape of the
paths of phases 10 and 11 that the resnet34 step lacks (bf16 timed, with
each path's sum of launches x ms against its bound), the resize kernels,
forward and backward in both types, at the two shapes of those paths that
the resnet34 step lacks (the resnet50 decoder's [16,2048,16,16] -> 32^2,
the bilinear UNet's [16,64,256,256] -> 512^2), the one-channel resizes of
those paths (the mask downsamples by 4, 8 and 16 and the request's
upscale) bit for bit, ``bn_relu`` at phase 9's fp32 shapes (its
widest [1,64,1424,2144] and its odd-sized bottom [1,1024,89,134]), at the
resnet50 encoder's C = 2048 in both types and on a view off a 16-byte
address (the scalar route) bit for bit, the
noise kernel at phase 13's augmentation shape [16,512,512,3], phase 16's
[8,512,512,3] and counts off a multiple of 4, and the bf16 Ci <= 8 conv
route at Ci 1, 3, 4 and 8 and at the plain UNet's [16,3,512,512]->64
(timed beside the wgmma kernel it replaces there, F.conv2d + 2 sums and,
in fp32, the fp32 kernel beside fp32 F.conv2d + 2 sums).

Serving and every comparison run in full fp32 (TF32 off for cuDNN
convolutions and matmuls); the training step of phase 6 in bf16.  The last
three lines are the kernels JSON, the ``nvidia-smi`` line and the result
JSON.  Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
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
import pandas as pd
import torch
import torch.nn.functional as F
from PIL import Image

from vaeunet_tpu_torch import build_model, native, predict_image, segmentation_distribution
from vaeunet_tpu_torch.cli import analyze as analyze_cli
from vaeunet_tpu_torch.cli import bench as bench_cli
from vaeunet_tpu_torch.cli import bench_tiled as bench_tiled_cli
from vaeunet_tpu_torch.cli import evaluate as evaluate_cli
from vaeunet_tpu_torch.cli import member_maps as member_maps_cli
from vaeunet_tpu_torch.cli import predict as predict_cli
from vaeunet_tpu_torch.cli import pretrain as pretrain_cli
from vaeunet_tpu_torch.cli import scale_ensemble as scale_ensemble_cli
from vaeunet_tpu_torch.cli import sweep as sweep_cli
from vaeunet_tpu_torch.cli import train as train_cli
from vaeunet_tpu_torch.cli import tune_fusion as tune_fusion_cli
from vaeunet_tpu_torch.cli import visualize as visualize_cli
from vaeunet_tpu_torch.compat import load_model
from vaeunet_tpu_torch.data import IDRIDDataset, augment
from vaeunet_tpu_torch.data.dataset import load_image, preprocess_pil
from vaeunet_tpu_torch.data.device_cache import (
    ImageDeviceCache,
    estimate_bytes,
    estimate_image_bytes,
)
from vaeunet_tpu_torch import uncertainty_maps, use_fp32_numerics
from vaeunet_tpu_torch.inference import expected_area_threshold, fused_probability
from vaeunet_tpu_torch.inference import predict_with_patches
from vaeunet_tpu_torch.inference.tiled import adaptive_overlap, compute_tile_grid
from vaeunet_tpu_torch.models import UNetResNet, build_unet
from vaeunet_tpu_torch.ops import _ext, collectives
from vaeunet_tpu_torch.ops.layers import BatchNorm, ConvTranspose2x
from vaeunet_tpu_torch.parallel import launch, make_dp_train_step, make_mesh, shard_batch
from vaeunet_tpu_torch.parallel.inference import (
    decode_samples,
    ensemble_sample_parallel,
    predict_tiled_sharded,
)
from vaeunet_tpu_torch.parallel.tp import shard_state
from vaeunet_tpu_torch.ops.resize import resize_bilinear
from vaeunet_tpu_torch.ops.pallas import bn_relu as bn_relu_mod
from vaeunet_tpu_torch.ops.pallas import bn_train as bn_train_mod
from vaeunet_tpu_torch.ops.pallas import clip_adamw as clip_adamw_mod
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
from vaeunet_tpu_torch.training.pretrain import (
    build_pretrain_model,
    create_pretrain_state,
    make_contrastive_step,
    make_pretrain_step,
)
from vaeunet_tpu_torch.training.state import ClippedAdamW
from vaeunet_tpu_torch.training.state import build_model as build_train_model
from vaeunet_tpu_torch.training.step import forward_loss, to_model_layout
from vaeunet_tpu_torch.utils import figures, profiling
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
# the noise kernel: one Philox4x32-10 call (10 rounds, ~100 integer ops) for 4
# elements, and the uniforms, log, sqrt, sincos and products (~56) for 2
NORMAL_OPS = 100 / 4 + 56 / 2
BN_RELU_OPS = 3               # mul, add, max
RESIZE_OPS = 9                # 3 lerps of (sub, mul, mul, add) sharing the (1 - lambda)


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


# The VAE-UNet's eval BN+ReLU pairs at a 512^2 tile: (C, H = W, launches
# of the resnet34 encoder, launches of one decoder sample).  Encoder: the
# stem, and the first conv of each of the 3, 4, 6, 3 blocks; decoder:
# z_initial, then at each level z_proj and the two convs
BN_RELU_LAYERS = ((64, 256, 1, 2), (64, 128, 3, 0), (128, 64, 4, 0), (256, 32, 6, 0),
                  (512, 16, 3, 1), (32, 32, 0, 1), (32, 64, 0, 1), (32, 128, 0, 1),
                  (32, 256, 0, 1), (512, 32, 0, 2), (256, 64, 0, 2), (128, 128, 0, 2))
# other shapes: the plain UNet request's (1424x2144, fp32) widest tensor and
# its odd-sized bottom, the resnet50 encoder's last stage, and the request's
# widest and narrowest in bf16
BN_RELU_OTHER_SHAPES = (((1, 64, 1424, 2144), (torch.float32,)),
                        ((1, 1024, 89, 134), (torch.float32,)),
                        ((8, 2048, 16, 16), (torch.float32, torch.bfloat16)),
                        ((8, 64, 256, 256), (torch.bfloat16,)),
                        ((8, 512, 16, 16), (torch.bfloat16,)))


def bn_relu_layers(batch: int, encoders: int, samples: int) -> list:
    """[(NCHW, launches)] of the twelve shapes for `encoders` tile batches
    of `batch` images, each decoded `samples` times."""
    return [((batch, c, hw, hw), enc * encoders + dec * encoders * samples)
            for c, hw, enc, dec in BN_RELU_LAYERS]


def bn_relu_stats(c: int, g) -> tuple:
    return (torch.rand(c, device="cuda", generator=g) + 0.5,
            torch.randn(c, device="cuda", generator=g),
            torch.randn(c, device="cuda", generator=g) * 0.5,
            torch.rand(c, device="cuda", generator=g) + 0.5)


def bn_relu_case(x: torch.Tensor, stats: tuple, name: str) -> dict:
    """The kernel against its plain version (fp32 within 1e-6, bf16 one
    ulp; bit for bit logged), then timed: through the wrapper ("w"), the
    launch alone ("a"), F.batch_norm + relu_, in turns, the least of three
    rounds; the launch and the library call on the device alone ("d", a
    CUDA graph of 50 of them replayed: no host work between two); the plain
    version; the bound."""
    scale, bias, mean, var = stats
    y = bn_relu_mod.fused_bn_relu(x, *stats)
    ref = bn_relu_mod.fused_bn_relu_plain(x, *bn_relu_mod.fold(*stats))
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    if x.dtype == torch.float32:
        check(err <= 1e-6, f"{name}: max err {err} > 1e-6")
    else:   # one bf16 ulp
        ulp_ok = ((y.float() - ref.float()).abs() <= ref.float().abs() * 2.0 ** -7).all().item()
        check(ulp_ok, f"{name}: differs by more than 1 ulp")
    same = torch.equal(y, ref)
    del ref
    fn, args = bn_relu_mod.launch_args(x, y, *stats, 1e-5)
    nbytes = 2 * x.numel() * x.element_size()
    it = iters_for(nbytes)
    t = paired_ms({"w": lambda: bn_relu_mod.fused_bn_relu(x, *stats),
                   "a": lambda: _ext.call("bn_relu", fn, x.device, *args),
                   "library": lambda: F.relu_(F.batch_norm(x, mean, var, scale, bias, False,
                                                          0.0, 1e-5))}, it)
    d = device_ms(lambda: _ext.call("bn_relu", fn, x.device, *args))
    d_library = device_ms(lambda: F.relu_(F.batch_norm(x, mean, var, scale, bias, False, 0.0,
                                                       1e-5)))
    a, b = bn_relu_mod.fold(*stats)
    plain = time_ms(lambda: bn_relu_mod.fused_bn_relu_plain(x, a, b), it)
    bnd, by = bound_ms(nbytes, BN_RELU_OPS * x.numel())
    plan = bn_relu_mod.plan(x.numel() // x.shape[1], x.shape[1], x.element_size(),
                            (x.data_ptr() | y.data_ptr()) % 16 == 0)
    log(f"{name}: err {err:.3g} (bit for bit: {same})  w {t['w']:.4f} ms  a {t['a']:.4f} ms  "
        f"d {d:.4f} ms ({nbytes / d / 1e9:.3f} TB/s, {bnd / d:.0%} of the bound)  plain "
        f"{plain:.4f} ms  F.batch_norm+relu_ {t['library']:.4f} ms (d {d_library:.4f} ms)  "
        f"bound {bnd:.4f} ms  {plan.route} V={plan.vec} block {plan.block} grid {plan.grid}")
    return dict(err=err, w=t["w"], a=t["a"], d=d, library=t["library"], d_library=d_library,
                plain=plain, bound=bnd, by=by)


def log_bn_relu_sums(what: str, cases: list) -> None:
    """Launches x ms summed over a path's shapes, and the shapes at which
    the launch alone (and the wrapper) is slower than the library call."""
    keys = ("a", "w", "d", "library", "d_library", "bound")
    sums = {k: sum(n * r[k] for _, n, r in cases) for k in keys}
    slower = {k: [list(s) for s, _, r in cases if r[k] > r[lib]] or "no shape"
              for k, lib in (("a", "library"), ("w", "library"), ("d", "d_library"))}
    log(f"bn_relu per {what}: launch alone {sums['a']:.3f} ms  wrapper {sums['w']:.3f} ms  "
        f"device alone {sums['d']:.3f} ms  F.batch_norm+relu_ {sums['library']:.3f} ms "
        f"(device alone {sums['d_library']:.3f} ms)  bound {sums['bound']:.3f} ms "
        f"({sums['bound'] / sums['a']:.0%} of the launches alone, "
        f"{sums['bound'] / sums['d']:.0%} of the device alone)")
    log(f"bn_relu launch alone slower than F.batch_norm+relu_ at: {slower['a']}; wrapper "
        f"slower at: {slower['w']}; device alone slower at: {slower['d']}")


def kernel_bn_relu(table: dict) -> None:
    """The request's twelve shapes in fp32 (batch 8, its launches per
    request) and the eval step's in bf16 (batch 16, one sample), each
    path's sum of launches x ms; the other paths' fp32 shapes; a tensor off
    a 16-byte address (the scalar route) bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = -(-len(compute_tile_grid(*IMAGE_HW, PATCH, OVERLAP)) // TILE_BATCH)
    sets = ((torch.float32, bn_relu_layers(TILE_BATCH, batches, N_SAMPLES),
             f"request ({batches} tile batches counted at {TILE_BATCH}, {N_SAMPLES} samples; "
             f"the whole-image encoder's 17 batch-1 launches not counted)"),
            (torch.bfloat16, bn_relu_layers(TRAIN_BATCH, 1, 1), "bf16 eval step (batch 16)"))
    for dtype, layers, what in sets:
        cases = []
        for shape, n in layers:
            x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last)
            name = f"bn_relu {list(shape)} {str(dtype)[6:]} x{n}"
            r = bn_relu_case(x, bn_relu_stats(shape[1], g), name)
            cases.append((shape, n, r))
            main = shape == (8, 64, 256, 256) and dtype == torch.float32
            _record(table, "bn_relu", err=r["err"], **(dict(
                ms=r["a"], wrapper_ms=r["w"], device_ms=r["d"], plain_ms=r["plain"],
                library_ms=r["library"], bound_ms=r["bound"], bound_by=r["by"],
                shape=f"{list(shape)} fp32") if main else {}))
            del x
        log_bn_relu_sums(what, cases)
    for shape, dtypes in BN_RELU_OTHER_SHAPES:
        for dtype in dtypes:
            x = torch.randn(shape, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last)
            r = bn_relu_case(x, bn_relu_stats(shape[1], g),
                             f"bn_relu {list(shape)} {str(dtype)[6:]}")
            _record(table, "bn_relu", err=r["err"])
            del x
    # a channels_last view 4 bytes off a 16-byte address: the scalar route
    base = torch.randn(8 * 32 * 32 * 64 + 1, device="cuda", generator=g)
    x = base[1:].view(8, 32, 32, 64).permute(0, 3, 1, 2)
    stats = bn_relu_stats(64, g)
    y = bn_relu_mod.fused_bn_relu(x, *stats)
    check("scalar" == bn_relu_mod.plan(8 * 32 * 32, 64, 4, x.data_ptr() % 16 == 0).route,
          "bn_relu: an offset view did not take the scalar route")
    check(torch.equal(y, bn_relu_mod.fused_bn_relu_plain(x, *bn_relu_mod.fold(*stats))),
          "bn_relu: the scalar route differs from the plain version")
    log("bn_relu [8,64,32,32] fp32 off a 16-byte address: scalar route, bit for bit")
    torch.cuda.empty_cache()


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
PRETEXT_NOISE_SHAPE = (8, 512, 512, 3)  # the contrastive pretext's, 2 draws a step
# counts off a multiple of 4 (the kernel's masked tail) beside the paths' shapes
NOISE_SHAPES = ((8192, 64), (3, 32), (1, 32), (7, 5), (1, 33), AUG_NOISE_SHAPE,
                PRETEXT_NOISE_SHAPE)


def kernel_noise(table: dict) -> None:
    """Each shape against the plain stream (1e-5: the ulps of log, sin and
    cos), a repeat bit for bit, a new seed different, the draw a prefix of a
    longer one; moments at the large ones; times beside torch.randn."""
    for shape in NOISE_SHAPES:
        z = reparam_mod.normal(shape, 11, "cuda")
        ref = reparam_mod.normal_plain(shape, 11, "cuda")
        torch.cuda.synchronize()
        err = (z - ref).abs().max().item()
        check(err <= 1e-5, f"normal {shape}: err {err} vs plain > 1e-5")
        check(torch.equal(z, reparam_mod.normal(shape, 11, "cuda")),
              f"normal {shape}: same seed gave different values")
        check(not torch.equal(z, reparam_mod.normal(shape, 12, "cuda")),
              f"normal {shape}: a new seed gave the same values")
        n = z.numel()
        check(torch.equal(z.flatten(), reparam_mod.normal((n + 3,), 11, "cuda")[:n]),
              f"normal {shape}: not a prefix of a longer draw")
        if n >= 8192 * 64:
            m, s = z.mean().item(), z.std().item()
            check(abs(m) < 0.01 and abs(s - 1) < 0.01, f"normal moments {m} {s}")
            log(f"normal {list(shape)}: mean {m:.5f} std {s:.5f}")
        if shape not in ((1, 32), AUG_NOISE_SHAPE, PRETEXT_NOISE_SHAPE):
            _record(table, "normal", err=err)
            continue
        dev = torch.device("cuda")
        big = n > 1 << 20
        t = paired_ms({"kernel": lambda: reparam_mod.normal(shape, 11, dev),
                       "randn": lambda: torch.randn(shape, device=dev)}, 100 if big else 1000)
        k_ms, l_ms = t["kernel"], t["randn"]
        # the launch alone into a tensor made beforehand: what is left of the
        # wrapper's time is its allocation and checks
        a_ms = time_ms(lambda: _ext.call("reparam", "vaeunet_normal", dev, z.data_ptr(), n, 11),
                       1000)
        p_ms = time_ms(lambda: reparam_mod.normal_plain(shape, 11, "cuda"), 10 if big else 200)
        bnd, by = bound_ms(4 * n, NORMAL_OPS * n)
        log(f"normal {list(shape)}: err {err:.3g}  kernel {k_ms:.4f} ms  launch alone "
            f"{a_ms:.4f} ms  plain {p_ms:.4f} ms  torch.randn {l_ms:.4f} ms  "
            f"bound {bnd:.6f} ms ({by})  "
            f"(kernel {'no slower than' if k_ms <= l_ms else 'SLOWER than'} torch.randn)")
        main = shape == (1, 32)
        _record(table, "normal", err=err, **(dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
            shape="[1, 32]") if main else {}))
        if not main:
            key = "augmentation_shape" if shape == AUG_NOISE_SHAPE else "pretext_shape"
            _record(table, "normal", **{key: dict(
                shape=str(list(shape)), ms=k_ms, launch_alone_ms=a_ms, plain_ms=p_ms,
                library_ms=l_ms, bound_ms=bnd, bound_by=by)})


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
    # the fused kernel draws the noise kernel's stream: z = mu + eps * std
    direct = mu + reparam_mod.normal(mu.shape, 7, "cuda") * (torch.exp(0.5 * logvar) * 2.0)
    d_err = (z2 - direct).abs().max().item()
    check(d_err <= 1e-5, f"reparam: {d_err} off mu + normal * std")
    check(not torch.equal(z, reparam_mod.reparameterize(mu, logvar, 8, 1.0)), "reparam: new seed")
    log(f"reparam [4096, 2]: err {err:.3g}  mean {z.mean(0).tolist()}  std {z.std(0).tolist()}"
        f"  vs mu + normal * std {d_err:.3g}")
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
    bnd, by = bound_ms(12 * n, (NORMAL_OPS + 5) * n)
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
    """The kernel's launch alone, its operands prepared beforehand as the
    wrapper prepares them (``launch_args``: the route's weights, and for the
    wgmma kernel x padded to a multiple of 8 channels): the device time
    where the wrapper's host work would hide it."""
    fn, args, _, keep = conv_mod.launch_args(x, w)

    def launch(keep=keep):   # the operands live as long as the launcher
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


# the plain UNet's first conv, the Ci <= 8 route's shape on the paths
CONV_SMALL_CI = ((16, 3, 512, 512), 64)
# the route at every Ci class of its K padding, on ragged H and W and B = 1
CONV_SMALL_CI_CHECKS = tuple(((1, ci, 37, 133), 64) for ci in (1, 3, 4, 8))


def kernel_conv_small_ci(table: dict, g) -> dict:
    """The bf16 Ci <= 8 route against the plain version (conv_case's bf16
    tolerances) at Ci 1, 3, 4, 8 on a ragged shape, then at the UNet's
    [16,3,512,512]->64, timed through the wrapper and alone beside
    F.conv2d + 2 sums; and the fp32 kernel timed at the same shape beside
    fp32 F.conv2d + 2 sums.  -> the bf16 timings."""
    for shape, co in CONV_SMALL_CI_CHECKS:
        check(conv_mod.route(shape[1], co, torch.bfloat16) == conv_mod.SMALL_CI_ENTRY,
              f"{list(shape)}->{co} bf16 does not take the Ci <= 8 route")
        _record(table, "conv_bn_stats_ci8",
                err=conv_case(g, shape, co, torch.bfloat16, timed=False)["err"])
    shape, co = CONV_SMALL_CI
    r = conv_case(g, shape, co, torch.bfloat16, launch_alone=True)
    # the wgmma kernel this route replaces at Ci <= 8, launched alone on its
    # prepared operands (x padded to 8 channels beforehand)
    x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn((co, shape[1], 3, 3), device="cuda", generator=g).to(torch.bfloat16)
    fn, args, _, keep = conv_mod.launch_args(x, w, conv_mod.WGMMA_ENTRY)
    r["replaced_ms"] = time_auto(lambda: _ext.call("conv_bn_stats", fn, x.device, *args))
    log(f"conv_bn_stats {list(shape)}->{co} bf16: the wgmma kernel it replaces there, launch "
        f"alone {r['replaced_ms']:.4f} ms (x padded beforehand); the Ci <= 8 kernel "
        f"{r['launch_ms']:.4f} ms")
    del x, w, args, keep
    _record(table, "conv_bn_stats_ci8", err=r["err"], ms=r["ms"], launch_ms=r["launch_ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], shape=f"{list(shape)}->{co} bf16",
            replaced_wgmma_ms=r["replaced_ms"])
    r32 = conv_case(g, shape, co, torch.float32, launch_alone=True)
    _record(table, "conv_bn_stats_fp32", err=r32["err"], small_ci_shape=dict(
        shape=f"{list(shape)}->{co} fp32", ms=r32["ms"], launch_ms=r32["launch_ms"],
        plain_ms=r32["plain_ms"], library_ms=r32["library_ms"], bound_ms=r32["bound_ms"],
        bound_by=r32["bound_by"]))
    log(f"conv_bn_stats fp32 at the UNet's Ci = 3: launch alone {r32['launch_ms']:.4f} ms "
        f"against fp32 F.conv2d+sums {r32['library_ms']:.4f} ms ("
        f"{'no slower' if r32['launch_ms'] <= r32['library_ms'] else 'SLOWER'})")
    torch.cuda.empty_cache()
    return r


def kernel_conv_new_shapes(table: dict, g, bf16: dict) -> None:
    """The shapes of the plain UNet's and the resnet50 VAE-UNet's steps
    that the resnet34 step does not have (Ci = 3 at 512^2, the ragged
    K chunks of Ci = 3104, 1056, 544, ...): both types held against the
    plain version, the bf16 launches timed beside F.conv2d + 2 sums, and
    each path's sum of launches x ms against its bound."""
    bf16[CONV_SMALL_CI] = kernel_conv_small_ci(table, g)
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
            check(torch.equal(gx, other), f"{name}: the chosen and the scalar kernels differ")
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


def kernel_resize_bwd_c1(table: dict) -> None:
    """The logits' gradient, g [16,1,512,512] -> gx [16,1,256,256], both
    conventions and both types: the row kernel, the scalar kernel and the
    plain version bit for bit (the plain version on the host, where
    index_add_ adds in index order; on the card it adds with atomics); the
    row kernel's launch alone timed in turns with the scalar kernel's and
    upsample_bilinear2d_backward, the least of three rounds, beside the
    wrapper, the plain version on the card and the bound."""
    g = torch.Generator(device="cuda").manual_seed(14)
    shape, out = (16, 1, 256, 256), 512
    for dtype in (torch.bfloat16, torch.float32):
        for ac in (True, False):
            gy = torch.randn((16, 1, out, out), device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last)
            gx = resize_mm.resize_backward(gy, shape[2:], ac)
            other = torch.empty_like(gx)
            fn, args = resize_mm.launch_args(gy, other, ac, backward=True, scalar=True)
            _ext.call("resize", fn, gy.device, *args)
            ref = resize_mm.resize_backward_plain(gy.cpu(), shape[2:], ac)
            torch.cuda.synchronize()
            name = f"resize_bwd {list(shape)}<-{out}^2 {str(dtype)[6:]} ac={ac}"
            err = (gx.cpu().float() - ref.float()).abs().max().item()
            check("_row_bwd_" in resize_mm.launch_args(gy, gx, ac, backward=True)[0],
                  f"{name}: did not take the row kernel")
            check(torch.equal(gx, other), f"{name}: the row and the scalar kernels differ")
            check(torch.equal(gx.cpu(), ref),
                  f"{name}: the row kernel and the plain version differ")
            del ref, other
            _record(table, "resize_bwd_c1", err=err)
            plan = resize_mm.plan_backward(shape[2:], (out, out), 1, gy.element_size(), ac, 16)
            nbytes = (gy.numel() + gx.numel()) * gy.element_size()
            bnd, by = bound_ms(nbytes, RESIZE_OPS * gy.numel())
            t = paired_ms({"alone": resize_launch_only(gy, gx, ac, True),
                           "scalar": lambda: _ext.call("resize", fn, gy.device, *args),
                           "library": lambda: torch.ops.aten.upsample_bilinear2d_backward(
                               gy, [out, out], list(shape), ac, None, None)}, 1000)
            w_ms = time_ms(lambda: resize_mm.resize_backward(gy, shape[2:], ac), 1000)
            d = {k: device_ms(f) for k, f in (
                ("row", resize_launch_only(gy, gx, ac, True)),
                ("scalar", lambda: _ext.call("resize", fn, gy.device, *args)),
                ("library", lambda: torch.ops.aten.upsample_bilinear2d_backward(
                    gy, [out, out], list(shape), ac, None, None)))}
            p_ms = time_ms(lambda: resize_mm.resize_backward_plain(gy, shape[2:], ac), 50)
            log(f"{name}: bit for bit (row = scalar = plain)  tile {plan.tile_h}x{plan.tile_w}, "
                f"{plan.blocks} blocks, {plan.smem_bytes} B shared  launch alone "
                f"{t['alone']:.4f} ms ({nbytes / t['alone'] / 1e9:.3f} TB/s, "
                f"{bnd / t['alone']:.0%} of the bound)  scalar kernel alone {t['scalar']:.4f} ms  "
                f"wrapper {w_ms:.4f} ms  plain {p_ms:.4f} ms  upsample_bilinear2d_backward "
                f"{t['library']:.4f} ms  bound {bnd:.4f} ms; device alone (a CUDA graph of 50 "
                f"launches): row {d['row']:.4f} ms  scalar {d['scalar']:.4f} ms  "
                f"upsample_bilinear2d_backward {d['library']:.4f} ms")
            if dtype == torch.bfloat16 and ac:
                _record(table, "resize_bwd_c1", ms=t["alone"], wrapper_ms=w_ms, plain_ms=p_ms,
                        library_ms=t["library"], bound_ms=bnd, bound_by=by,
                        scalar_ms=t["scalar"], device_ms=d["row"],
                        shape=f"g {[16, 1, out, out]} bf16 ac=True")
            del gy, gx
    torch.cuda.empty_cache()


# the training BN sites timed: the UNet's widest and resnet34's (bf16, ReLU)
BN_TRAIN_SHAPES = ((16, 64, 512, 512), (16, 64, 256, 256))


def kernel_bn_train(table: dict) -> None:
    """The training BN + ReLU kernels at the widest site of each training
    cell: the forward against the plain version on the card bit for bit,
    running statistics included; the backward twice, bit for bit, and
    within a bf16 ulp (+ 1e-5 of the largest term) of the plain closed
    form.  Timed: through the wrapper ("w"), the launch alone ("a"), a CUDA
    graph of 10 launches ("d"); the plain versions; the library yardstick,
    training ``F.batch_norm`` + ``relu`` and their autograd backward (never
    called by the port); the bounds, y in and out out forward, g and y in
    and dy out backward."""
    g = torch.Generator(device="cuda").manual_seed(17)
    cl = torch.channels_last
    for shape in BN_TRAIN_SHAPES:
        c = shape[1]
        y = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.5).to(torch.bfloat16)
        y = y.contiguous(memory_format=cl)
        y32 = y.float()
        s, q = y32.sum((0, 2, 3)), (y32 * y32).sum((0, 2, 3))
        del y32
        grad = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
            memory_format=cl)
        w = torch.rand(c, device="cuda", generator=g) + 0.5
        b = torch.randn(c, device="cuda", generator=g) * 0.5
        stats = (torch.randn(c, device="cuda", generator=g), torch.rand(c, device="cuda") + 0.5,
                 torch.zeros((), dtype=torch.int64, device="cuda"))
        ours = bn_train_mod.Running(*(t.clone() for t in stats), 0.1)
        ref = bn_train_mod.Running(*(t.clone() for t in stats), 0.1)
        out = bn_train_mod.bn_train(y, s, q, w, b, True, 1e-5, ours)
        want = bn_train_mod.bn_train_plain(y, s, q, w, b, True, 1e-5, ref)
        torch.cuda.synchronize()
        name = f"bn_train {list(shape)} bf16 relu"
        check(torch.equal(out, want) and all(torch.equal(x, z) for x, z in zip(ours, ref)
                                             if isinstance(x, torch.Tensor)),
              f"{name}: the forward or the running statistics differ from the plain version")
        del want
        dy = torch.empty_like(y, memory_format=cl)
        fn_b, args_b, grads, keep = bn_train_mod.backward_launch_args(grad, y, dy, s, q, w, b,
                                                                      True, 1e-5)
        _ext.call("bn_train", fn_b, y.device, *args_b)
        first = (dy.clone(), *(t.clone() for t in grads))
        _ext.call("bn_train", fn_b, y.device, *args_b)
        torch.cuda.synchronize()
        check(all(torch.equal(x, z) for x, z in zip(first, (dy, *grads))),
              f"{name}: the backward does not repeat bit for bit")
        plain = bn_train_mod.bn_train_backward_plain(grad, y, s, q, w, b, True, 1e-5)
        _, _, inv = bn_train_mod.fold_moments(s, q, y.numel() // c, 1e-5, w)
        top = max(plain[0].float().abs().max().item(),
                  inv.abs().max().item() * grad.float().abs().max().item())
        diff = (dy.float() - plain[0].float()).abs()
        err = diff.max().item()
        check(bool((diff <= 2.0 ** -7 * plain[0].float().abs() + 1e-5 * top).all()),
              f"{name}: dy beyond a bf16 ulp + 1e-5 of the plain closed form ({err})")
        err_wb = max(((x - z).abs().max() / z.abs().max()).item()
                     for x, z in zip(grads, plain[1:]))
        check(err_wb <= 1e-4, f"{name}: dweight or dbias differ by {err_wb} of their max")
        del plain, diff
        fn_f, args_f = bn_train_mod.forward_launch_args(y, out, s, q, w, b, True, 1e-5, None)
        nbytes = y.numel() * y.element_size()
        it = iters_for(3 * nbytes)
        t = paired_ms({
            "fwd_w": lambda: bn_train_mod.bn_train(y, s, q, w, b, True, 1e-5, None),
            "fwd_a": lambda: _ext.call("bn_train", fn_f, y.device, *args_f),
            "bwd_w": lambda: bn_train_mod._backward_cuda(grad, y, s, q, w, b, True, 1e-5),
            "bwd_a": lambda: _ext.call("bn_train", fn_b, y.device, *args_b)}, it)
        d_fwd = device_ms(lambda: _ext.call("bn_train", fn_f, y.device, *args_f), 10, 5)
        d_bwd = device_ms(lambda: _ext.call("bn_train", fn_b, y.device, *args_b), 10, 5)
        plain_fwd = time_ms(lambda: bn_train_mod.bn_train_plain(y, s, q, w, b, True), 5)
        plain_bwd = time_ms(lambda: bn_train_mod.bn_train_backward_plain(grad, y, s, q, w, b,
                                                                         True), 5)
        yl, wl, bl = y.detach().requires_grad_(), w.clone().requires_grad_(), b.clone(
        ).requires_grad_()
        rm, rv = stats[0].clone(), stats[1].clone()

        def library():
            return F.relu(F.batch_norm(yl, rm, rv, wl, bl, True, 0.1, 1e-5))

        lib_fwd = time_ms(library, 10)
        lib_out = library()
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (yl, wl, bl), grad,
                                                      retain_graph=True), 10)
        bnd_fwd, by = bound_ms(2 * nbytes + 32 * c, 0)
        bnd_bwd, _ = bound_ms(3 * nbytes, 0)
        r_plan = bn_train_mod.plan(y.numel() // c, c, 2, True, bn_train_mod._sms(y.device))
        log(f"{name} forward: bit for bit (running statistics too)  w {t['fwd_w']:.4f} ms  "
            f"a {t['fwd_a']:.4f} ms  d {d_fwd:.4f} ms ({bnd_fwd / d_fwd:.0%} of the bound)  "
            f"plain {plain_fwd:.4f} ms  F.batch_norm+relu {lib_fwd:.4f} ms  bound "
            f"{bnd_fwd:.4f} ms ({by})")
        log(f"{name} backward: repeats bit for bit, dy max err {err:.3g} vs the plain closed "
            f"form, dweight/dbias {err_wb:.3g} of their max  w {t['bwd_w']:.4f} ms  a "
            f"{t['bwd_a']:.4f} ms  d {d_bwd:.4f} ms ({bnd_bwd / d_bwd:.0%} of the bound)  plain "
            f"{plain_bwd:.4f} ms  autograd of F.batch_norm+relu {lib_bwd:.4f} ms  bound "
            f"{bnd_bwd:.4f} ms  sums pass {r_plan.reduce.block} x {r_plan.reduce.grid}, dy "
            f"pass {r_plan.apply.block} x {r_plan.apply.grid}")
        if shape == BN_TRAIN_SHAPES[0]:
            for key, ms, wrapper, dev, pl, lib, bnd in (
                    ("bn_train_fwd", t["fwd_a"], t["fwd_w"], d_fwd, plain_fwd, lib_fwd, bnd_fwd),
                    ("bn_train_bwd", t["bwd_a"], t["bwd_w"], d_bwd, plain_bwd, lib_bwd, bnd_bwd)):
                _record(table, key, err=err if key == "bn_train_bwd" else 0.0, ms=ms,
                        wrapper_ms=wrapper, device_ms=dev, plain_ms=pl, library_ms=lib,
                        bound_ms=bnd, bound_by="bytes", shape=f"{list(shape)} bf16 relu")
        del y, grad, out, dy, first, grads, keep, yl, lib_out
        torch.cuda.empty_cache()


# the training BNs off the fused sites timed (bf16, no ReLU: each is summed
# before its ReLU): a resnet50 bn3 at batch 32, a UNet gate's 32-wide BN and
# its psi at batch 16
BN_BATCH_SHAPES = ((32, 256, 128, 128), (16, 32, 512, 512), (16, 1, 512, 512))
# the EfficientNet-B4 VAE-UNet's BN + SiLU sites at 512^2, batch 32: the first
# expansion at 256^2, a stage-1 expansion at 128^2, the widest at 16^2
BN_BATCH_SILU_SHAPES = ((32, 144, 256, 256), (32, 192, 128, 128), (32, 1632, 16, 16))


def kernel_bn_batch(table: dict) -> None:
    """The training BN kernels over a tensor's own moments (``bn_batch_``):
    the moments within fp32 summation of x's sums, the forward against the
    plain version on those moments bit for bit, running statistics
    included; the backward twice, bit for bit, and within a bf16 ulp (+
    1e-5 of the largest term) of the plain closed form.  Timed as
    ``kernel_bn_train``: "w", "a", "d" (a CUDA graph of 10 calls), the
    plain versions, training ``F.batch_norm`` and its autograd backward as
    the yardstick (the path these kernels replaced); the bounds, x in and
    out out forward (the moments pass reads x once more), g and x in and
    dx out backward.  The identity at ``BN_BATCH_SHAPES``, the SiLU (against
    ``F.batch_norm`` + ``F.silu``) at ``BN_BATCH_SILU_SHAPES``."""
    g = torch.Generator(device="cuda").manual_seed(19)
    cl = torch.channels_last
    silu = bn_train_mod.SILU
    cases = [(shape, 0) for shape in BN_BATCH_SHAPES]
    cases += [(shape, silu) for shape in BN_BATCH_SILU_SHAPES]
    for shape, act in cases:
        c = shape[1]
        x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.5).to(torch.bfloat16)
        x = x.contiguous(memory_format=cl)
        grad = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(
            memory_format=cl)
        w = torch.rand(c, device="cuda", generator=g) + 0.5
        b = torch.randn(c, device="cuda", generator=g) * 0.5
        stats = (torch.randn(c, device="cuda", generator=g), torch.rand(c, device="cuda") + 0.5,
                 torch.zeros((), dtype=torch.int64, device="cuda"))
        ours = bn_train_mod.Running(*(t.clone() for t in stats), 0.1)
        ref = bn_train_mod.Running(*(t.clone() for t in stats), 0.1)
        out, moments = bn_train_mod._batch_forward_cuda(x, w, b, act, 1e-5, ours)
        s, q = moments[:c], moments[c:2 * c]
        x32 = x.float()
        sums = (x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3)))
        err_m = max(((k - z).abs() / z.abs().clamp_min(1e-30)).max().item()
                    for k, z in zip((s, q), sums))
        del x32
        want = bn_train_mod.bn_train_plain(x, s.clone(), q.clone(), w, b, act, 1e-5, ref)
        torch.cuda.synchronize()
        name = f"bn_batch {list(shape)} bf16" + (" SiLU" if act else "")
        check(err_m <= 1e-5,
              f"{name}: the moments differ from x's fp32 sums by {err_m} relative")
        check(torch.equal(out, want) and all(torch.equal(v, z) for v, z in zip(ours, ref)
                                             if isinstance(v, torch.Tensor)),
              f"{name}: the forward or the running statistics differ from the plain version")
        del want

        def backward():
            return bn_train_mod._batch_backward_cuda(grad, x, moments, w, b, act, 1e-5)

        first = [t.clone() for t in backward()]
        again = backward()
        torch.cuda.synchronize()
        check(all(torch.equal(v, z) for v, z in zip(first, again)),
              f"{name}: the backward does not repeat bit for bit")
        plain = bn_train_mod.bn_train_backward_plain(grad, x, s, q, w, b, act, 1e-5)
        _, _, inv = bn_train_mod.fold_moments(s, q, x.numel() // c, 1e-5, w)
        top = max(plain[0].float().abs().max().item(),
                  inv.abs().max().item() * grad.float().abs().max().item())
        diff = (first[0].float() - plain[0].float()).abs()
        err = diff.max().item()
        check(bool((diff <= 2.0 ** -7 * plain[0].float().abs() + 1e-5 * top).all()),
              f"{name}: dx beyond a bf16 ulp + 1e-5 of the plain closed form ({err})")
        err_wb = max(((v - z).abs().max() / z.abs().max()).item()
                     for v, z in zip(first[1:], plain[1:]))
        check(err_wb <= 1e-4, f"{name}: dweight or dbias differ by {err_wb} of their max")
        del plain, diff, again
        fn_f, args_f, keep_f = bn_train_mod.batch_forward_launch_args(x, out, w, b, act, 1e-5,
                                                                      None)
        dx = torch.empty_like(x, memory_format=cl)
        fn_b, args_b, _, keep_b = bn_train_mod.batch_backward_launch_args(grad, x, dx, moments,
                                                                          w, b, act, 1e-5)
        nbytes = x.numel() * x.element_size()
        it = iters_for(3 * nbytes)
        t = paired_ms({
            "fwd_w": lambda: bn_train_mod.bn_batch(x, w, b, act, 1e-5, None),
            "fwd_a": lambda: _ext.call("bn_train", fn_f, x.device, *args_f),
            "bwd_w": backward,
            "bwd_a": lambda: _ext.call("bn_train", fn_b, x.device, *args_b)}, it)
        d_fwd = device_ms(lambda: _ext.call("bn_train", fn_f, x.device, *args_f), 10, 5)
        d_bwd = device_ms(lambda: _ext.call("bn_train", fn_b, x.device, *args_b), 10, 5)
        plain_fwd = time_ms(lambda: bn_train_mod.bn_batch_plain(x, w, b, act), 5)
        plain_bwd = time_ms(lambda: bn_train_mod.bn_train_backward_plain(grad, x, s, q, w, b,
                                                                         act), 5)
        xl, wl, bl = x.detach().requires_grad_(), w.clone().requires_grad_(), b.clone(
        ).requires_grad_()
        rm, rv = stats[0].clone(), stats[1].clone()

        def library():
            y = F.batch_norm(xl, rm, rv, wl, bl, True, 0.1, 1e-5)
            return F.silu(y) if act else y

        lib_fwd = time_ms(library, 10)
        lib_out = library()
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (xl, wl, bl), grad,
                                                      retain_graph=True), 10)
        bnd_fwd, by = bound_ms(2 * nbytes + 32 * c, 0)
        bnd_bwd, _ = bound_ms(3 * nbytes, 0)
        p = bn_train_mod.plan(x.numel() // c, c, 2, True, bn_train_mod._sms(x.device))
        log(f"{name} forward: moments within {err_m:.3g} of x's fp32 sums, bit for bit on them "
            f"(running statistics too)  w {t['fwd_w']:.4f} ms  a {t['fwd_a']:.4f} ms  d "
            f"{d_fwd:.4f} ms ({bnd_fwd / d_fwd:.0%} of the bound)  plain {plain_fwd:.4f} ms  "
            f"F.batch_norm{' + F.silu' if act else ''} {lib_fwd:.4f} ms  bound {bnd_fwd:.4f} ms ({by})  moments pass "
            f"{p.reduce.block} x {p.reduce.grid}, normalisation {p.apply.block} x "
            f"{p.apply.grid}")
        log(f"{name} backward: repeats bit for bit, dx max err {err:.3g} vs the plain closed "
            f"form, dweight/dbias {err_wb:.3g} of their max  w {t['bwd_w']:.4f} ms  a "
            f"{t['bwd_a']:.4f} ms  d {d_bwd:.4f} ms ({bnd_bwd / d_bwd:.0%} of the bound)  plain "
            f"{plain_bwd:.4f} ms  autograd of F.batch_norm {lib_bwd:.4f} ms  bound "
            f"{bnd_bwd:.4f} ms")
        if shape in (BN_BATCH_SHAPES[0], BN_BATCH_SILU_SHAPES[0]):
            pre = "bn_batch_silu" if act else "bn_batch"
            for key, ms, wrapper, dev, pl, lib, bnd in (
                    (pre + "_fwd", t["fwd_a"], t["fwd_w"], d_fwd, plain_fwd, lib_fwd, bnd_fwd),
                    (pre + "_bwd", t["bwd_a"], t["bwd_w"], d_bwd, plain_bwd, lib_bwd, bnd_bwd)):
                _record(table, key, err=err if key.endswith("_bwd") else 0.0, ms=ms,
                        wrapper_ms=wrapper, device_ms=dev, plain_ms=pl, library_ms=lib,
                        bound_ms=bnd, bound_by="bytes", shape=f"{list(shape)} bf16")
        del x, grad, out, moments, dx, first, keep_f, keep_b, xl, lib_out
        torch.cuda.empty_cache()


# the training configurations whose parameter sets phase 3 steps: (label,
# train_config's fields)
CLIP_ADAMW_SETS = (("resnet34 VAE-UNet", {}), ("resnet50 VAE-UNet", {"backbone": "resnet50"}),
                   ("plain UNet", {"model_type": "basic"}))


def foreach_clip_(grads: list, max_norm: float) -> torch.Tensor:
    """The clip's library design, a yardstick the port never calls:
    optax's formula on torch's foreach ops, the tensors' norms, their norm,
    then g / d * c, where (d, c) is (1, 1) under max_norm (g itself) and
    (norm, max_norm) at or above it; no host sync -> the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def host_ms(fn, iters: int = 20) -> float:
    """Mean host time of fn() over `iters` back-to-back calls after a
    synchronize: the enqueue alone where the device keeps up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def kernel_clip_adamw(table: dict) -> None:
    """The optimizer step's kernels at each training configuration's
    parameter set: one step with gradients under the clip (both paths keep
    them) equal bit for bit to ``clip_`` + torch's foreach AdamW, parameters
    and moments; a step that clips, its norm within a relative 2e-7 of the
    Python sum's.  Timed with gradients under the clip (32 bytes an element,
    the bound): the step through the wrapper ("w", ``ClippedAdamW.step``,
    back to back), its host enqueue alone, the two launches alone ("a"), a
    CUDA graph of them ("d"), the norm launch's graph alone; today's path
    (``clip_`` + torch's foreach AdamW) and the library design,
    :func:`foreach_clip_` + torch's fused AdamW (never called by the port),
    each back to back and its host enqueue alone."""
    for label, fields in CLIP_ADAMW_SETS:
        config = train_config(**fields)
        ours = create_train_state(config, seed=0, device="cuda").optimizer
        params = ours.params
        elems = sum(p.numel() for p in params)
        twins = {}
        for kind in ("ref", "lib"):
            ps = [torch.nn.Parameter(p.detach().clone()) for p in params]
            twins[kind] = ClippedAdamW(ps, config)
        ref, lib = twins["ref"], twins["lib"]
        lib_adamw = torch.optim.AdamW(lib.params, lr=config.learning_rate, betas=(0.9, 0.999),
                                      eps=1e-8, weight_decay=config.weight_decay, fused=True)

        def library():
            norm = foreach_clip_([p.grad for p in lib.params], lib.max_norm)
            lib_adamw.step()
            return norm

        g = torch.Generator(device="cuda").manual_seed(21)
        grads = [torch.empty_like(p).normal_(generator=g) for p in params]
        for scale, what in ((1e-5, "keeps"), (1e-3, "clips")):
            for o in (ours, ref, lib):
                for p, gr in zip(o.params, grads):
                    p.grad = gr * scale
            norm = ours.step()
            own = ref.clip_()
            ref.adamw.step()
            lib_norm = library()
            torch.cuda.synchronize()
            n, o, ln = norm.item(), own.item(), lib_norm.item()
            if what == "keeps":
                same = all(torch.equal(p, q) and torch.equal(ours.adamw.state[p][k],
                                                             ref.adamw.state[q][k])
                           for p, q in zip(params, ref.params)
                           for k in ("exp_avg", "exp_avg_sq"))
                check(same and n < 1.0, f"clip_adamw {label}: a step under the clip differs "
                      f"from clip_ + torch's AdamW (norm {n})")
            else:
                check(n >= 1.0 and abs(n - o) <= 2e-7 * o,
                      f"clip_adamw {label}: norm {n} against the Python sum's {o}")
            # the library design is a yardstick: its norm is the same sum in
            # another order, its fused AdamW rounds otherwise
            lib_gap = max((p - q).abs().max().item() for p, q in zip(lib.params, ref.params))
            check(abs(ln - o) <= 1e-6 * o and lib_gap <= 1e-6,
                  f"clip_adamw {label}: the library design's norm {ln} against {o}, its "
                  f"parameters {lib_gap} from today's path's")
        for o in (ours, ref, lib):           # under the clip again: the timed steps
            for p, gr in zip(o.params, grads):
                p.grad = gr * 1e-5
        state = ours.kernel_state()
        plan = state.plan
        norm = clip_adamw_mod.norm(plan)
        group = ours.adamw.param_groups[0]
        state.count_step(group)
        clip_adamw_mod.update(plan, norm, group, ours.max_norm)
        n_args = clip_adamw_mod.norm_args(plan, norm)
        u_args = clip_adamw_mod.update_args(plan, norm, group, ours.max_norm)

        def launches_alone():
            _ext.call("clip_adamw", clip_adamw_mod.NORM_FN, plan.device, *n_args)
            _ext.call("clip_adamw", clip_adamw_mod.UPDATE_FN, plan.device, *u_args)

        def today():
            ref.clip_()
            ref.adamw.step()

        t = paired_ms({"w": ours.step, "a": launches_alone, "lib": library}, 20)
        host = host_ms(ours.step)
        lib_host = host_ms(library)
        d = device_ms(launches_alone, 10, 10)
        d_norm = device_ms(lambda: _ext.call("clip_adamw", clip_adamw_mod.NORM_FN, plan.device,
                                             *n_args), 10, 10)
        plain = time_ms(today, 5)
        plain_host = host_ms(today, 5)
        bnd, _ = bound_ms(32 * elems, 0)
        bnd_norm, _ = bound_ms(4 * elems, 0)
        log(f"clip_adamw {label}: {len(params)} tensors, {elems} elements; a step under the clip "
            f"bit for bit with clip_ + torch's AdamW, a clipping one's norm within 2e-7 of the "
            f"Python sum's  w {t['w']:.4f} ms (host enqueue {host:.4f} ms)  a {t['a']:.4f} ms  "
            f"d {d:.4f} ms ({bnd / d:.0%} of the bound)  norm launch d {d_norm:.4f} ms "
            f"({bnd_norm / d_norm:.0%} of its {bnd_norm:.4f} ms)  today's path {plain:.4f} ms "
            f"(host {plain_host:.4f} ms)  foreach clip + fused AdamW {t['lib']:.4f} ms (host "
            f"{lib_host:.4f} ms)  bound {bnd:.4f} ms (bytes, 32 an element)  grid: up to "
            f"{plan.blocks} blocks")
        if not fields:
            _record(table, "clip_adamw", err=0.0, ms=t["a"], wrapper_ms=t["w"], device_ms=d,
                    plain_ms=plain, library_ms=t["lib"], bound_ms=bnd, bound_by="bytes",
                    shape=f"{label}: {len(params)} tensors, {elems} elements")
        del ours, ref, lib, lib_adamw, twins, params, grads, state, plan, norm
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
    kernel_resize_bwd_c1(table)
    kernel_bn_train(table)
    kernel_bn_batch(table)
    kernel_clip_adamw(table)
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


def tiled_decodes(hw, tile_batch: int, samples: int, overlap=OVERLAP) -> dict:
    """Launches of `samples` tiled decodes of an image of `hw` (each tile
    batch: 13 BN+ReLU pairs, z_initial + 4 x (z_proj, bn1, bn2), and 5
    resizes, the logits' on the row kernel), with the tile encoder (17
    resnet34 pairs a tile batch); and the grid's tiles against the encoder
    slots they take, the last batch padded."""
    tiles = len(compute_tile_grid(*hw, PATCH, overlap))
    batches = -(-tiles // tile_batch)
    return launches(bn_relu=17 * batches + 13 * batches * samples,
                    resize=5 * batches * samples, resize_row=batches * samples,
                    tiles=tiles, tile_slots=batches * tile_batch)


def request_launches(hw, tile_batch: int, samples: int = N_SAMPLES, overlap=OVERLAP) -> dict:
    """One tiled ``segmentation_distribution``: the whole-image encoder, the
    fused draw, the tiled decodes."""
    return add_counts(launches(bn_relu=17, reparam=1),
                      tiled_decodes(hw, tile_batch, samples, overlap))


def add_counts(*counts: dict) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def expected_launches() -> dict:
    """Launches the serving path's code implies for this phase: the
    requests, and one sampled predict_image at 512^2."""
    return add_counts(*[request_launches(IMAGE_HW, TILE_BATCH)] * N_REQUESTS,
                      launches(bn_relu=17 + 13, resize=5, resize_row=1, normal=1))


def phase_slice(model) -> dict:
    g = torch.Generator(device="cuda").manual_seed(4)
    image = torch.rand((*IMAGE_HW, 3), device="cuda", generator=g)
    small = torch.rand((512, 512, 3), device="cuda", generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    for r in range(N_REQUESTS):
        samples, mu, logvar = segmentation_distribution(
            model, image, torch.Generator().manual_seed(100 + r), num_samples=N_SAMPLES,
            temperature=TEMPERATURE, patch_size=PATCH, tile_batch=TILE_BATCH, overlap=OVERLAP)
        maps = uncertainty_maps(samples)
        check(tuple(samples.shape) == (N_SAMPLES, *IMAGE_HW, 1), f"samples {samples.shape}")
        check(bool(torch.isfinite(samples).all()), "non-finite samples")
        check(bool(((samples >= 0) & (samples <= 1)).all()), "samples outside [0, 1]")
        check(tuple(mu.shape) == (32,) and bool(torch.isfinite(mu).all()), "mu")
        check(tuple(logvar.shape) == (32,) and bool(torch.isfinite(logvar).all()), "logvar")
        for k, v in maps.items():
            check(tuple(v.shape) == (*IMAGE_HW, 1) and bool(torch.isfinite(v).all()),
                  f"uncertainty map {k}")
        log(f"request {r}: mean p {maps['mean'].mean().item():.4f}  "
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
    log(f"peak memory: {peak:.2f} GiB  (fp32, TF32 off)")
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
WARMUP_STEPS, COUNTED_STEPS = 3, 10


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


_PARAM_ELEMS: dict = {}


def param_elems(**fields) -> int:
    """The parameters' elements of train_config(**fields)'s model (built
    once, on the CPU)."""
    key = tuple(sorted(fields.items()))
    if key not in _PARAM_ELEMS:
        model = build_train_model(train_config(**fields), device="cpu")
        _PARAM_ELEMS[key] = sum(p.numel() for p in model.parameters())
    return _PARAM_ELEMS[key]


def optimizer_launches(elems: int, steps: int = 1) -> dict:
    """`steps` optimizer steps on the card of a model of `elems` parameter
    elements, each with a gradient: a norm and an update launch a step."""
    return launches(steps, clip_adamw_norm=1, clip_adamw_update=1, clip_adamw_elems=elems)


# the wrappers' counters, one `_ext.call` each ("resize_row",
# "resize_bwd_row" and "conv_bn_stats_fp32" count a share of their wrapper's)
CALL_COUNTERS = ("normal", "reparam", "bn_relu", "resize", "resize_bwd", "conv_bn_stats",
                 "conv_bn_stats_ci8", "bn_train_fwd", "bn_train_bwd", "bn_batch_fwd",
                 "bn_batch_bwd", "clip_adamw_norm", "clip_adamw_update")


def ext_calls(counts: dict) -> int:
    """The `_ext.call`s behind `counts`' launches."""
    return sum(counts[k] for k in CALL_COUNTERS)


def expected_train_launches(steps: int, amp: bool = True) -> dict:
    """Launches the training path's code implies: per forward, 29 encoder
    (stage sizes 3, 4, 6, 3: every block's conv2 and its stride-1 conv1) and
    8 decoder conv + BN pairs take the conv kernel, 4 decoder upsamples and
    the final one to 512^2 the resize kernel, whose backward runs as often,
    and the latent draw one noise kernel; each conv + BN site's BN and
    ReLU take the training BN kernels once forward and once backward, and
    the 24 BNs off those sites (the stem, the 3 strided convs', the 3
    downsamples', z_initial, the 4 z_proj and the gates' 12) the
    ``bn_batch`` kernels once each way; eval BN+ReLU and the fused draw are
    not on this path.  The logits' resize
    and its gradient take the row kernels, and without `amp` every conv
    launch the fp32 kernel.  The optimizer step: its two kernels over every
    parameter."""
    return add_counts(
        launches(steps, conv_bn_stats=29 + 8, conv_bn_stats_fp32=0 if amp else 29 + 8,
                 bn_train_fwd=29 + 8, bn_train_bwd=29 + 8, bn_batch_fwd=24, bn_batch_bwd=24,
                 resize=5, resize_row=1,
                 resize_bwd=5, resize_bwd_row=1, normal=1),
        optimizer_launches(param_elems(), steps))


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
    losses = []
    for _ in range(COUNTED_STEPS):
        state, aux = step(state, images, masks, beta)
        losses.append(aux["loss"].item())
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"losses {losses}")
    log(f"train steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}  peak memory {peak:.2f} GiB")
    expected = expected_train_launches(COUNTED_STEPS)
    log(f"train launches over {COUNTED_STEPS} steps: {counts}  expected {expected}")
    for k in ("conv_bn_stats", "bn_train_fwd", "bn_train_bwd", "bn_batch_fwd", "bn_batch_bwd",
              "resize", "resize_row",
              "resize_bwd", "resize_bwd_row", "normal"):
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
    expected_eval = launches(bn_relu=17 + 13, resize=5, resize_row=1, normal=1)
    log(f"eval step: {({k: round(v.item(), 5) for k, v in metrics.items()})}  launches {ecounts}")
    check(ecounts == expected_eval, f"eval launch counts {ecounts} differ from {expected_eval}")
    del state, step, eval_step, images, masks, logits
    torch.cuda.empty_cache()
    return counts


# ----- phase 7 -------------------------------------------------------------

FP32_WARMUP_STEPS, FP32_COUNTED_STEPS = 2, 5


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
    losses = []
    for _ in range(FP32_COUNTED_STEPS):
        state, aux = step(state, images, masks, 0.001)
        losses.append(aux["loss"].item())
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"fp32 losses {losses}")
    log(f"fp32 train steps (amp=False, TF32 off): loss {losses[0]:.5f} -> {losses[-1]:.5f}  "
        f"peak memory {peak:.2f} GiB")
    expected = expected_train_launches(FP32_COUNTED_STEPS, amp=False)
    log(f"fp32 train launches over {FP32_COUNTED_STEPS} steps: {counts}  expected {expected}")
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
    for r in range(N_REQUESTS):
        probs, _ = predict_image(model, scaled)
        full = resize_bilinear(probs[None].permute(0, 3, 1, 2), IMAGE_HW, align_corners=False)
        mask = full[0, 0] > 0.5
        check(tuple(full.shape) == (1, 1, *IMAGE_HW) and bool(torch.isfinite(full).all())
              and bool(((full >= 0) & (full <= 1)).all()), "UNet request probabilities")
        check(mask.dtype == torch.bool and tuple(mask.shape) == IMAGE_HW, "UNet request mask")
        log(f"UNet request {r}: mask share {mask.float().mean().item():.4f}")
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = launches(N_REQUESTS, bn_relu=18, resize=1, resize_row=1)
    log(f"UNet requests ({list(UNET_SCALED_HW)} in, {list(IMAGE_HW)} out): "
        f"peak memory {peak:.2f} GiB  (fp32, TF32 off)")
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

NEW_WARMUP_STEPS, NEW_COUNTED_STEPS = 3, 5


def train_path(config: TrainConfig, label: str, per_step: dict) -> tuple:
    """The 512^2 batch-16 step of `config`: the first step moves every
    parameter and leaves it finite; 3 warm and 5 counted steps, whose launch
    counts must equal `per_step` x 5 and the optimizer's two kernels a step
    over every parameter.  -> (state, counts, images, masks)."""
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
    losses = []
    for _ in range(NEW_COUNTED_STEPS):
        state, aux = step(state, images, masks, 0.001)
        losses.append(aux["loss"].item())
    counts = _ext.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(map(lambda v: v == v and abs(v) < 1e6, losses)), f"{label} losses {losses}")
    log(f"{label} train steps: peak memory {peak:.2f} GiB  "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    expected = add_counts(launches(NEW_COUNTED_STEPS, **per_step), optimizer_launches(
        sum(p.numel() for p in state.model.parameters()), NEW_COUNTED_STEPS))
    log(f"{label} launches over {NEW_COUNTED_STEPS} steps: {counts}  expected {expected}")
    check(counts == expected, f"{label} launch counts {counts} differ from the code's {expected}")
    return state, counts, images, masks


def phase_unet_train() -> list:
    """The bench.py step settings on the plain UNet, both ``bilinear``
    settings: 18 conv-kernel launches a step (the first, Ci = 3, on the
    Ci <= 8 route, the other 17 on the wgmma kernel), and with ``bilinear`` 4
    resizes forward and 4 backward; one eval step (18 ``bn_relu``); then one
    fp32 step card vs CPU at 128^2."""
    out = []
    for bilinear in (False, True):
        config = train_config(model_type="basic", bilinear=bilinear)
        label = f"UNet bilinear={bilinear}"
        up = 4 if bilinear else 0
        state, counts, images, masks = train_path(
            config, label, dict(conv_bn_stats=17, conv_bn_stats_ci8=1, bn_train_fwd=18,
                                bn_train_bwd=18, bn_batch_fwd=12, bn_batch_bwd=12, resize=up,
                                resize_bwd=up))
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
        dict(conv_bn_stats=21, bn_train_fwd=21, bn_train_bwd=21, bn_batch_fwd=57,
             bn_batch_bwd=57, resize=5 + 3, resize_row=1 + 3, resize_bwd=5, resize_bwd_row=1,
             normal=1))
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
    check(base["counts"]["bn_train_fwd"] == 37 == base["counts"]["bn_train_bwd"],
          "remat none: training BN launches")
    # the recompute runs every site's BN again under both policies
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
        check((r["counts"]["bn_train_fwd"], r["counts"]["bn_train_bwd"]) == (74, 37),
              f"remat {policy}: training BN launches {r['counts']['bn_train_fwd']} forward, "
              f"{r['counts']['bn_train_bwd']} backward, expected 74 and 37")
    check(base["tracked"] == {1}, f"remat none: num_batches_tracked {base['tracked']}")
    check(runs["full"]["peak"] < base["peak"], "remat full holds no less memory than none")
    check(runs["full"]["held"] < runs["save_convs"]["held"] < base["held"],
          "the forward's saved activations do not shrink from none to save_convs to full")
    return total


# ----- phase 13 ------------------------------------------------------------

FUNDUS_SPLITS = (("train", 4), ("val", 2))
LOOP_SCALE, LOOP_EPOCHS = 0.5, 2
TRAIN_STEP_LAUNCHES = dict(conv_bn_stats=37, bn_train_fwd=37, bn_train_bwd=37, bn_batch_fwd=24,
                           bn_batch_bwd=24, resize=5, resize_row=1, resize_bwd=5,
                           resize_bwd_row=1, normal=2)
EVAL_STEP_LAUNCHES = dict(bn_relu=17 + 13, resize=5, resize_row=1, normal=1)


def write_fundus_set(root: Path, seed: int, splits=FUNDUS_SPLITS) -> None:
    """IDRiD's layout at IDRiD's 2848x4288: JPG fundus images (a bright disk
    cut at top and bottom, as IDRiD's are, with yellow exudate blobs) and
    their EX masks as TIFs, from `seed`, for each (split, count)."""
    rng = np.random.RandomState(seed)
    h, w = IMAGE_HW
    yy, xx = np.ogrid[:h, :w]
    disk = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.6 * h) ** 2
    for split, n in splits:
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
    per_train = add_counts(launches(steps, **TRAIN_STEP_LAUNCHES),
                           optimizer_launches(param_elems(), steps))
    per_eval = launches(validations * val_batches, **EVAL_STEP_LAUNCHES)
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


def phase_loop(root: Path) -> dict:
    """The training loop through ``train_model`` on a synthetic IDRiD set
    at IDRiD's own size: the flagship at full width, the image-level device
    cache and the augmentation on, 2 epochs; then a resume from ``best``
    for one more epoch; then one epoch host-fed (no device cache, the
    pinned copies).  The data, caches and checkpoints go under `root`,
    which phase 14 reads.  -> the launch counts of the three runs."""
    os.environ["WANDB_MODE"] = "disabled"       # the tracker stays offline
    native.require()
    total = launches()
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

    # the indexed, augmented step: a finite loss, every parameter moves
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model, augment=True, indexed=True,
                           gather=cache.make_gather())
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    state, aux = step(state, cache.images, cache.masks, cache.batch_indices(idx), 0.001)
    check(bool(torch.isfinite(aux["loss"])), f"indexed augmented step: loss {aux['loss']}")
    first_step_moved_everything(state.model, before)
    del state, step, before, cache, images, masks
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


# ----- phase 14 ------------------------------------------------------------

TEST_SPLIT = (("test", 2),)
# fundi the analyze CLI takes: one, since with two the phase took 142.6 s
# (PERF.md, PR 8), over its 90 s share of the run; 30 s of each fundus is
# host metrics
ANALYZE_IMAGES = 1
ANALYZE_BATCH = 4             # analyze_model.py's --batch_size default: the tile batch
FUSION_SCALES = (1.0, 0.5)
VIZ_SCALE, VIZ_SAMPLES, VIZ_TEMPS = 0.5, 5, (0.5, 1.0)
EVAL_SCALE, EVAL_BATCH = 0.5, 6     # evaluate.py's --batch-size default
PREDICT_SCALE = 0.5
GLOBAL_PNGS = ("global_calibration_curve.png", "ece_vs_temperature.png",
               "global_sparsification_curve.png", "global_uncertainty_distribution.png",
               "global_error_roc_pr.png", "global_segmentation_roc_curve.png")
EXTENDED_COLUMNS = ("brier", "nll", "mean_entropy", "mean_mutual_info",
                    "mean_coeff_variation", "uncertain_pixel_percent")


@contextlib.contextmanager
def in_dir(path: Path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def step_counts(label: str, expected: dict, smi: str) -> dict:
    """The launches since the last reset, held against `expected`."""
    torch.cuda.synchronize()
    counts = _ext.launch_counts()
    log(f"{label} launches: {counts}  expected {expected}  [{smi}]")
    check(counts == expected, f"{label}: launch counts {counts} differ from the code's {expected}")
    return counts


def phase_analysis(root: Path) -> dict:
    """The analysis path through its CLIs, on phase 13's tree: the flagship
    from phase 13's ``best`` run dir, and a test split of 2 fundi at
    2848x4288 added from a seed.  Loads (the run dir and the same weights
    as a reference-format .pth: equal state dicts, logits within 1e-6),
    analyzes (``cli.analyze``), fuses two scales (``fused_probability``),
    visualizes (``cli.visualize``), evaluates (``cli.evaluate``) and
    predicts (``cli.predict``, a plain-UNet .pth); each step's launches held
    to the code's.  -> the phase's launch counts."""
    os.environ["WANDB_MODE"] = "disabled"           # the tracker stays offline
    os.environ["VAEUNET_CACHE_DIR"] = str(root / "cache")
    use_fp32_numerics()
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    data = root / "idrid"
    write_fundus_set(data, seed=22, splits=TEST_SPLIT)
    log(f"analysis data: {sum(n for _, n in TEST_SPLIT)} test fundus JPGs + EX TIFs at "
        f"{IMAGE_HW[0]}x{IMAGE_HW[1]} written in {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = launches()

    # 1. the run dir and the same weights as a reference .pth load alike
    run_dir = loop_config(root).checkpoint_path()
    _ext.reset_launch_counts()
    model, config = load_model(run_dir)
    pth = root / "flagship.pth"
    torch.save({"model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "params": {"lesion_type": config.lesion_type, "patch_size": config.patch_size,
                           "img_scale": config.img_scale, "beta": config.beta,
                           "free_bits": config.free_bits,
                           "kl_anneal_epochs": config.kl_anneal_epochs,
                           "latent_injection": config.latent_injection,
                           "use_attention": config.use_attention, "seed": config.seed,
                           "model_type": config.model_type}}, pth)
    from_pth, pth_config = load_model(str(pth))
    sa, sb = model.state_dict(), from_pth.state_dict()
    check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
          "the .pth's state dict differs from the run dir's")
    x = to_nchw(torch.rand((1, 512, 512, 3), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(26)))
    with torch.inference_mode():
        err = (model(x, sample=False)[0] - from_pth(x, sample=False)[0]).abs().max().item()
    log(f"load: {run_dir} and {pth.name}: {len(sa)} tensors equal bit for bit, logits at "
        f"512^2 differ by {err:.3g}; the .pth's config: {pth_config.model_type}, "
        f"{pth_config.backbone}, latent {pth_config.latent_dim}, "
        f"'{pth_config.latent_injection}'  [{smi}]")
    check(err <= 1e-6, f"logits of the two loads differ by {err} > 1e-6")
    check(isinstance(model, UNetResNet) and model.latent_dim == 32
          and model.latent_injection == "all", "the run dir is not the flagship")
    total = add_counts(total, step_counts("load", launches(2, bn_relu=30, resize=5,
                                                           resize_row=1), smi))
    del from_pth

    # 2. analyze_model.py's request through the CLI
    out = root / "analysis"
    report: dict = {}
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    with in_dir(root):                               # the tracker's ./runs
        df = analyze_cli.main([
            "--model", run_dir, "--lesion_type", "EX", "--scale", "1.0", "--patch_size",
            str(PATCH), "--overlap", str(OVERLAP), "--samples", str(N_SAMPLES),
            "--temperature", "1", "--batch_size", str(ANALYZE_BATCH),
            "--max_images", str(ANALYZE_IMAGES), "--extended-metrics",
            "--data-dir", str(data), "--output_dir", str(out)], report=report)
    analyze_s = time.perf_counter() - t0
    expected = add_counts(*(request_launches(r["hw"], ANALYZE_BATCH)
                            for r in report["images"]))
    total = add_counts(total, step_counts("analyze", expected, smi))
    for r in report["images"]:
        log(f"analyze {r['img_id']} ({r['hw'][0]}x{r['hw'][1]}, N={N_SAMPLES}, tiles "
            f"{PATCH}/{OVERLAP}, tile batch {ANALYZE_BATCH}): request {r['request_s']:.3f} s "
            f"(ends in torch.cuda.synchronize), samples to the host {r['fetch_s']:.3f} s, "
            f"host metrics and spills {r['host_s']:.3f} s  [{smi}]")
    renderer = "matplotlib" if figures.pyplot() is not figures.LITE else "the PIL renderer"
    log(f"analyze global stage (plots by {renderer}, global metrics): "
        f"{report['global_s']:.3f} s; the CLI end to end {analyze_s:.1f} s  [{smi}]")
    results = out / f"EX_T1.0_N{N_SAMPLES}"
    csv = pd.read_csv(results / "analysis_metrics.csv")
    columns = ["img_id", "dice", "ece", "sparsification_error", "uncertainty_error_dice",
               "error_auroc", "error_auprc", *EXTENDED_COLUMNS]
    values = csv[columns[1:]].to_numpy(dtype=np.float64)
    log(f"analysis_metrics.csv: {len(csv)} rows, {len(csv.columns)} columns; "
        f"{csv[columns[1:7]].round(4).to_dict('records')}")
    check(len(df) == len(csv) == ANALYZE_IMAGES and list(csv.columns) == columns,
          f"the CSV has {len(csv)} rows and columns {list(csv.columns)}")
    check(bool(np.isfinite(values).all()), "non-finite analysis metrics")
    check(all((results / png).exists() for png in GLOBAL_PNGS), "a global plot is missing")
    check(not (results / "temp_pixel_data").exists(), "the spill dir was left behind")

    # 3. two scales fused
    fundus = load_image(data / "imgs" / "test" / "IDRiD_00.jpg")
    members = [(model, preprocess_pil(fundus, s, is_mask=False).astype(np.float32) / 255.0)
               for s in FUSION_SCALES]
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    fused, stack = fused_probability(members, torch.Generator(device="cuda").manual_seed(23),
                                     num_samples=N_SAMPLES, patch_size=PATCH,
                                     tile_batch=TILE_BATCH)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    adaptive = adaptive_overlap(PATCH)
    expected = add_counts(*(request_launches(m[1].shape[:2], TILE_BATCH, overlap=adaptive)
                            for m in members), launches(resize=1, resize_row=1))
    total = add_counts(total, step_counts("fusion", expected, smi))
    threshold = expected_area_threshold(fused)
    log(f"fusion of {[m[1].shape[:2] for m in members]} (scales {FUSION_SCALES}, N="
        f"{N_SAMPLES}, tiles {PATCH}/{adaptive}): {fuse_s:.3f} s; fused mean "
        f"{fused.mean().item():.4f}, expected-area threshold {threshold:.4f}  [{smi}]")
    check(tuple(fused.shape) == (*IMAGE_HW, 1) and tuple(stack.shape) == (2, *IMAGE_HW, 1),
          f"fused {tuple(fused.shape)}, members {tuple(stack.shape)}")
    check(bool(torch.isfinite(fused).all()) and bool((fused >= stack).all()),
          "the max fusion is below a member's mean")
    check(0.0 < threshold <= 1.0, f"expected-area threshold {threshold}")
    del fused, stack, members

    # 4. visualize_vae.py through the CLI, one image
    test_ds = IDRIDDataset(str(data), split="test", scale=VIZ_SCALE, patch_size=None,
                           lesion_type="EX", max_images=1, skip_border_check=True)
    viz_hw = test_ds.get_image_and_mask(test_ds.unique_image_ids()[0])[0].shape[:2]
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    written = visualize_cli.main([
        "--model", run_dir, "--scale", str(VIZ_SCALE), "--patch_size", str(PATCH),
        "--samples", str(VIZ_SAMPLES), "--compare_temperatures", "--ensemble",
        "--temperatures", *map(str, VIZ_TEMPS), "--max_images", "1", "--data-dir", str(data),
        "--output_dir", str(root / "figures")])
    viz_s = time.perf_counter() - t0
    ensemble = tiled_decodes(viz_hw, ANALYZE_BATCH, VIZ_SAMPLES)
    expected = add_counts(
        *[request_launches(viz_hw, ANALYZE_BATCH, VIZ_SAMPLES)] * (1 + len(VIZ_TEMPS)),
        launches(bn_relu=17), *[add_counts(ensemble, launches(reparam=1))] * len(VIZ_TEMPS))
    total = add_counts(total, step_counts("visualize", expected, smi))
    log(f"visualize ({viz_hw[0]}x{viz_hw[1]}, N={VIZ_SAMPLES}, T {VIZ_TEMPS}): {viz_s:.1f} s, "
        f"{[p.name for p in written]}  [{smi}]")
    check(len(written) == 3 and all(p.exists() for p in written), f"figures {written}")

    # 5. evaluate.py through the CLI on the val split
    val_ds = IDRIDDataset(str(data), split="val", scale=EVAL_SCALE, patch_size=TRAIN_HW,
                          lesion_type="EX")
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = evaluate_cli.main(["--model", run_dir, "--split", "val", "--scale",
                                 str(EVAL_SCALE), "--patch-size", str(TRAIN_HW),
                                 "--data-dir", str(data)])
    eval_s = time.perf_counter() - t0
    batches = -(-len(val_ds) // EVAL_BATCH)
    total = add_counts(total, step_counts("evaluate", launches(batches, **EVAL_STEP_LAUNCHES),
                                          smi))
    log(f"evaluate ({len(val_ds)} val patches, {batches} batches): {eval_s:.2f} s, "
        f"{ {k: round(v, 4) for k, v in metrics.items()} }  [{smi}]")
    check(len(metrics) > 0 and all(np.isfinite(list(metrics.values()))),
          f"evaluate metrics {metrics}")
    del model
    torch.cuda.empty_cache()

    # 6. predict.py through the CLI: a plain-UNet .pth, one fundus PNG
    unet = build_unet(3, 1, bilinear=False, seed=24, device="cuda")
    randomize_bn_stats(unet, seed=25)
    unet_pth = root / "unet.pth"
    torch.save({"model_state_dict": {k: v.cpu() for k, v in unet.state_dict().items()},
                "params": {"model_type": "basic"}}, unet_pth)
    png = root / "fundus.png"
    fundus.save(png)
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    masks = predict_cli.main(["--model", str(unet_pth), "--input", str(png), "--scale",
                              str(PREDICT_SCALE)])
    predict_s = time.perf_counter() - t0
    total = add_counts(total, step_counts("predict", launches(bn_relu=18, resize=1,
                                                              resize_row=1), smi))
    mask = np.asarray(Image.open(masks[0])) > 0
    arr = preprocess_pil(Image.open(png).convert("RGB"), PREDICT_SCALE,
                         is_mask=False).astype(np.float32) / 255.0
    probs, _ = predict_image(unet, arr)
    ref = (resize_bilinear(probs[None].permute(0, 3, 1, 2), IMAGE_HW,
                           align_corners=False)[0, 0] > 0.5).cpu().numpy()
    log(f"predict ({arr.shape[0]}x{arr.shape[1]} in, mask {mask.shape[0]}x{mask.shape[1]}): "
        f"{predict_s:.2f} s, mask share {mask.mean():.4f}, equal to predict_image + resize + "
        f"threshold: {bool(np.array_equal(mask, ref))}  [{smi}]")
    check(mask.shape == IMAGE_HW, f"predict mask {mask.shape}")
    check(bool(np.array_equal(mask, ref)), "the predict CLI's mask differs from phase 9's "
          "computation on the same weights")
    del unet, probs
    torch.cuda.empty_cache()

    log(f"analysis phase: peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
        f"{time.perf_counter() - t_phase:.1f} s in all  [{smi}]")
    return total


# ----- phase 15 ------------------------------------------------------------

PAR_BATCH = 16           # the two-rank fp32 steps' global batch (8 rows a rank)
TP_BATCH = 4             # the channel-sharded step's batch (every model rank's)
TP_MIN_CHANNELS = 256
ENSEMBLE_HW = 1024       # the sample-parallel ensemble decodes the whole image
PAR_TIMED_STEPS = 3
# the two-rank steps' gradients (averaged over the ranks) against one rank's,
# by relative L2.  The per-device and the channel-sharded steps sum what one
# rank sums, in its order (measured 2.8e-6 and 4.5e-6 on an H100).  The
# global-batch step sums BN moments and batch reductions in another order,
# which this model's fp32 gradient amplifies: 2.1e-3, as much as one rank's
# gradient of the same batch with its halves swapped (`reorder_floor`,
# logged each run).  A mean taken as a sum, a rank's rows dropped or a
# moment's cotangent lost give 0.3 and more.
SPLIT_GRAD_LIMIT, DP_GRAD_LIMIT = 1e-4, 5e-3


def on_host(tree: dict) -> dict:
    """A copy of each tensor on the host (a copy on the CPU as well)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def host_state(model: torch.nn.Module) -> dict:
    return on_host(model.state_dict())


def device_grads(model: torch.nn.Module) -> dict:
    """A copy of every parameter's gradient, on its device."""
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def train_batch(seed: int, batch: int, device="cuda") -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand((batch, TRAIN_HW, TRAIN_HW, 3), device=device, generator=g)
    masks = (torch.rand((batch, TRAIN_HW, TRAIN_HW, 1), device=device, generator=g)
             > 0.9).float()
    return images, masks


def parallel_noise() -> torch.Tensor:
    """The latent noise of the two-rank steps, [1, PAR_BATCH, 32]."""
    return torch.randn((1, PAR_BATCH, 32), generator=torch.Generator().manual_seed(12))


def counted(fn):
    """fn() with the launch counters set to 0 just before and read just
    after (the card synchronized) -> (result, counts, seconds)."""
    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, _ext.launch_counts(), time.perf_counter() - t0


def rank_world_one(ctx) -> dict:
    """Phase 15 (a), one rank over NCCL: the flagship's global-batch DP
    step (bf16, 512^2, batch 16) and ``make_train_step``'s from the same
    weights, batch and generator: the same loss and parameters, bit for
    bit (an all-reduce over one rank is the identity; cuDNN's deterministic
    algorithms, since its backward is otherwise not bit-exact from run to
    run)."""
    torch.backends.cudnn.deterministic = True
    config = train_config()
    images, masks = train_batch(9, TRAIN_BATCH, ctx.device)
    out = {"backend": ctx.backend}
    results = []
    for dp in (False, True):
        state = create_train_state(config, seed=0, device=ctx.device)
        step = (make_dp_train_step(config, ctx, state.model) if dp
                else make_train_step(config, state.model))
        (state, aux), counts, sec = counted(lambda: step(state, images, masks, 0.001))
        out["dp_counts" if dp else "counts"] = counts
        out["dp_s" if dp else "s"] = sec
        results.append((aux["loss"].item(), host_state(state.model)))
        del state, step
        torch.cuda.empty_cache()
    (l0, s0), (l1, s1) = results
    out.update(loss=l1, same_loss=l0 == l1,
               same_state=all(torch.equal(s0[k], s1[k]) for k in s0))
    return out


def rank_parallel(ctx) -> dict:
    """Phase 15 (b), on each of two ranks: the fp32 global-batch DP step
    (TF32 off, global batch 16; its gradient averaged over the ranks, then
    the step) and 3 timed ones; the per-device step on fed noise (the
    same); the channel-sharded step on a (1, 2) mesh of the same ranks
    (its gathered gradient, clip norm and whole parameters); the
    sample-parallel ensemble (N = 10) of a 1024^2 image; the tile-sharded
    prediction of a 2848x4288 image.  Rank 0 returns the tensors."""
    use_fp32_numerics()
    config = train_config(amp=False)
    images, masks = train_batch(9, PAR_BATCH, ctx.device)
    eps = parallel_noise()
    half = PAR_BATCH // ctx.n_data
    mine = slice(ctx.data_rank * half, (ctx.data_rank + 1) * half)
    keep = ctx.rank == 0
    out = {"rank": ctx.rank, "backend": ctx.backend}

    def step_keeping_grads(step, state, *batch, **kw):
        """compute_gradients (the gradient averaged over the data group),
        a copy of the gradient, then the optimizer step: ``step(...)``."""
        aux = step.compute_gradients(state, *batch, 0.001, **kw)
        grads = device_grads(state.model)
        state.optimizer.step()
        state.step += 1
        return aux, grads

    state = create_train_state(config, seed=0, device=ctx.device)
    step = make_dp_train_step(config, ctx, state.model)
    im_r, mk_r = shard_batch(ctx, images, masks)
    (aux, grads), out["dp_counts"], out["dp_cold_s"] = counted(
        lambda: step_keeping_grads(step, state, im_r, mk_r))
    out["dp_loss"] = aux["loss"].item()
    if keep:
        out["dp_state"], out["dp_grads"] = host_state(state.model), on_host(grads)
    del grads
    times = []
    for _ in range(PAR_TIMED_STEPS):
        t0 = time.perf_counter()
        state, aux = step(state, im_r, mk_r, 0.001)
        aux["loss"].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["dp_step_s"] = times
    del state, step
    torch.cuda.empty_cache()

    state = create_train_state(config, seed=0, device=ctx.device)
    step = make_dp_train_step(config, ctx, state.model, explicit=True)
    (aux, grads), out["explicit_counts"], _ = counted(
        lambda: step_keeping_grads(step, state, images[mine], masks[mine], eps=eps[:, mine]))
    out["explicit_loss"] = aux["loss"].item()
    if keep:
        out["explicit_state"] = host_state(state.model)
        out["explicit_grads"] = on_host(grads)
    del state, step, grads
    torch.cuda.empty_cache()

    tp_ctx = make_mesh(ctx.world_size, model_axis=2, device=ctx.device)
    state = create_train_state(config, seed=0, device=ctx.device)
    names = shard_state(state, config, tp_ctx, TP_MIN_CHANNELS)
    step = make_train_step(config, state.model)
    tb = slice(0, TP_BATCH)

    def tp_step():
        aux = step.compute_gradients(state, images[tb], masks[tb], 0.001, eps=eps[:, tb])
        grads = {n: (collectives.gather(p.grad, 0, tp_ctx.model) if n in names
                     else p.grad.clone()) for n, p in state.model.named_parameters()}
        full = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads.values()))
        norm = state.optimizer.step()
        return aux, grads, full.item(), norm.item()

    (aux, grads, full_norm, norm), out["tp_counts"], _ = counted(tp_step)
    out["tp_elems"] = sum(p.numel() for p in state.model.parameters())
    params = dict(state.model.named_parameters())
    whole = {k: (collectives.gather(params[k].detach(), 0, tp_ctx.model) if k in names else v)
             for k, v in state.model.state_dict().items()}
    out.update(tp_loss=aux["loss"].item(), tp_norm=norm, tp_full_norm=full_norm,
               tp_sharded=len(names))
    if keep:
        out["tp_grads"], out["tp_state"] = on_host(grads), on_host(whole)
    del state, step, grads, whole, params
    torch.cuda.empty_cache()

    # the plain UNet's: its wide convs column-parallel, up1-3's transposed
    # convs row-parallel
    config_u = train_config(amp=False, model_type="basic", bilinear=False)
    state = create_train_state(config_u, seed=0, device=ctx.device)
    names = shard_state(state, config_u, tp_ctx, TP_MIN_CHANNELS)
    step = make_train_step(config_u, state.model)

    def unet_tp_gradient():
        aux = step.compute_gradients(state, images[tb], masks[tb], 0.001)
        return aux, {n: (collectives.gather(p.grad, 0, tp_ctx.model) if n in names
                         else p.grad.clone()) for n, p in state.model.named_parameters()}

    (aux, grads), out["unet_tp_counts"], _ = counted(unet_tp_gradient)
    out.update(unet_tp_loss=aux["loss"].item(), unet_tp_sharded=names)
    if keep:
        out["unet_tp_grads"] = on_host(grads)
    del state, step, grads
    torch.cuda.empty_cache()

    model = build_model(backbone="resnet34", latent_dim=32, latent_injection="all", seed=0,
                        device=ctx.device)
    randomize_bn_stats(model, seed=1)
    image, zs, big = inference_inputs(ctx.device)
    ens, out["ensemble_counts"], out["ensemble_s"] = counted(
        lambda: ensemble_sample_parallel(model, image, zs, ctx))
    tiled, out["tiled_counts"], out["tiled_s"] = counted(
        lambda: predict_tiled_sharded(model, big, zs[:1], ctx, patch_size=PATCH,
                                      overlap=OVERLAP, batch_size=TILE_BATCH))
    if keep:
        out["ensemble"], out["tiled"] = ens.cpu(), tiled.cpu()
    return out


class HandSplitConvTranspose2x(ConvTranspose2x):
    """``ConvTranspose2x`` with its input channels in two halves whose
    outputs are added, then the bias: the two row-parallel ranks'
    arithmetic (their all-reduce is one commutative addition) in one
    process, the reference of the UNet's TP gradient."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        half = w.shape[0] // 2
        cl = torch.channels_last
        y0, y1 = (F.conv_transpose2d(x[:, i * half:(i + 1) * half].contiguous(memory_format=cl),
                                     w[i * half:(i + 1) * half], None, stride=2
                                     ).contiguous(memory_format=cl) for i in range(2))
        return (y0 + y1) + self.bias.to(x.dtype).view(1, -1, 1, 1)


def hand_split(model: torch.nn.Module, sharded) -> None:
    """The sharded transposed convs of `model` as HandSplitConvTranspose2x."""
    modules = dict(model.named_modules())
    for name in sharded:
        mod = modules[name.rpartition(".")[0]]
        if type(mod) is ConvTranspose2x:
            mod.__class__ = HandSplitConvTranspose2x


def inference_inputs(device) -> tuple:
    """(a 1024^2 image, N = 10 latents, a 2848x4288 image), from seeds."""
    g = torch.Generator(device=device).manual_seed(4)
    image = torch.rand((ENSEMBLE_HW, ENSEMBLE_HW, 3), device=device, generator=g)
    big = torch.rand((*IMAGE_HW, 3), device=device, generator=g)
    zs = torch.randn((N_SAMPLES, 32), generator=torch.Generator().manual_seed(5))
    return image, zs, big


def rel_l2(got: dict, ref: dict) -> float:
    ours = torch.cat([got[k].flatten() for k in ref])
    theirs = torch.cat([v.flatten() for v in ref.values()])
    return ((ours - theirs).norm() / theirs.norm()).item()


def grads_held(label: str, got: dict, ref: dict, limit: float,
               head: str = "final_conv") -> float:
    """A two-rank step's gradient against the one-rank computation's: the
    whole by relative L2 within `limit`, and the output conv `head` (which
    no BN follows) per element within 1e-3 of its max |g|
    (``tests/torch_train_parity.py``'s head check)."""
    check(set(got) == set(ref), f"{label}: gradients of other parameters")
    check(all(bool(torch.isfinite(v).all()) for v in got.values()),
          f"{label}: a gradient is not finite")
    rel = rel_l2(got, ref)
    head_err = max((got[k] - ref[k]).abs().max().item() / ref[k].abs().max().item()
                   for k in (f"{head}.weight", f"{head}.bias"))
    worst = sorted(((rel_l2({k: got[k]}, {k: v}), k) for k, v in ref.items()
                    if v.norm() > 0), reverse=True)[:3]
    log(f"{label}: gradient relative L2 {rel:.3g} (limit {limit:g}), {head} max err "
        f"{head_err:.3g} of its max |g| (limit 1e-3); worst tensors "
        f"{[(k, float(f'{e:.3g}')) for e, k in worst]}")
    check(rel <= limit, f"{label}: the gradient differs by {rel} (relative L2)")
    check(head_err <= 1e-3, f"{label}: the {head} gradient differs by {head_err} of its max")
    return rel


def reorder_floor(config, images: torch.Tensor, masks: torch.Tensor,
                  eps: torch.Tensor) -> float:
    """The relative L2 between one rank's gradients of the batch and of the
    same batch with its two halves swapped (the rows' noise with them): the
    same function, summed in another order."""
    grads = []
    for rows in (torch.arange(PAR_BATCH), torch.arange(PAR_BATCH).roll(PAR_BATCH // 2)):
        state = create_train_state(config, seed=0, device="cuda")
        make_train_step(config, state.model).compute_gradients(
            state, images[rows.cuda()], masks[rows.cuda()], 0.001, eps=eps[:, rows])
        grads.append(on_host(device_grads(state.model)))
        del state
    return rel_l2(grads[1], grads[0])


def held_to_harness(label: str, got: dict, ref: dict, lr: float) -> None:
    """tests/torch_train_parity.py's bounds on a state after one step:
    parameters within 2 lr (+ 1e-6), running statistics within 1e-4 + 1e-3
    |ref|."""
    err_p = max((got[k] - v).abs().max().item() for k, v in ref.items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    err_s = max(((got[k] - v).abs() - 1e-3 * v.abs()).max().item()
                for k, v in ref.items() if k.endswith(("running_mean", "running_var")))
    log(f"{label}: parameters max err {err_p:.3g} (2 lr = {2 * lr:g}), running statistics "
        f"max err beyond 1e-3 |ref| {err_s:.3g}")
    check(err_p <= 2 * lr + 1e-6, f"{label}: parameters differ by {err_p} > 2 lr")
    check(err_s <= 1e-4, f"{label}: running statistics differ beyond 1e-4 + 1e-3 |ref|")


def phase_parallel() -> dict:
    """Data, tensor and sample parallelism on the card (``parallel/``),
    each rank a process started by ``parallel.launch``: (a) one rank over
    NCCL; (b) two ranks over gloo sharing the card (NCCL where there are
    two cards), held against the one-rank computations of this process.
    -> the ranks' launch counts of the phase, summed."""
    use_fp32_numerics()
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    total = launches()

    (a,) = launch(rank_world_one, 1, device="cuda", timeout=300)
    expected = expected_train_launches(1)
    log(f"(a) one rank over {a['backend']}: DP step vs make_train_step, bf16 512^2 b16: loss "
        f"{a['loss']:.6f}, same loss {a['same_loss']}, same parameters and statistics "
        f"{a['same_state']}; cold steps {a['s']:.3f} / {a['dp_s']:.3f} s  [{smi}]")
    log(f"(a) DP step launches {a['dp_counts']}  expected {expected}")
    check(a["backend"] == "nccl", f"one rank ran over {a['backend']}, not NCCL")
    check(a["same_loss"] and a["same_state"], "the one-rank DP step differs from the step")
    check(a["dp_counts"] == expected == a["counts"],
          f"DP step launches {a['dp_counts']} differ from the code's {expected}")
    total = {k: total[k] + a["dp_counts"][k] for k in total}

    share = torch.cuda.device_count() < 2
    t0 = time.perf_counter()
    ranks = launch(rank_parallel, 2, device="cuda", share_devices=share, timeout=900)
    r0 = ranks[0]
    log(f"(b) two ranks over {r0['backend']} ({'sharing the card' if share else 'a card each'})"
        f": {time.perf_counter() - t0:.1f} s in all  [{smi}]")
    for r in ranks:
        for key in ("dp_counts", "explicit_counts", "tp_counts", "unet_tp_counts",
                    "ensemble_counts", "tiled_counts"):
            total = {k: total[k] + r[key][k] for k in total}
    config = train_config(amp=False)
    lr = config.learning_rate
    images, masks = train_batch(9, PAR_BATCH)
    eps = parallel_noise()

    # the global-batch DP step = the one-rank step on the global batch
    state = create_train_state(config, seed=0, device="cuda")
    aux = make_train_step(config, state.model).compute_gradients(state, images, masks, 0.001)
    ref_grads = on_host(device_grads(state.model))
    state.optimizer.step()
    ref_loss = aux["loss"].item()
    log(f"(b) DP step fp32 (TF32 off), global batch {PAR_BATCH}: loss {r0['dp_loss']:.7f} vs "
        f"the one-rank step's {ref_loss:.7f}; cold {r0['dp_cold_s']:.3f} s, warm "
        f"{[round(t, 4) for t in r0['dp_step_s']]} s (8 rows a rank)")
    check(abs(r0["dp_loss"] - ref_loss) <= 1e-5 + 2e-6 * abs(ref_loss),
          "the DP step's loss differs from the one-rank step's")
    floor = reorder_floor(config, images, masks, eps)
    log(f"(b) one rank, the batch's halves swapped: gradient relative L2 {floor:.3g}")
    grads_held("(b) DP step vs the one-rank step", r0["dp_grads"], ref_grads, DP_GRAD_LIMIT)
    held_to_harness("(b) DP step vs the one-rank step", r0["dp_state"], host_state(state.model),
                    lr)
    per_rank = expected_train_launches(1, amp=False)
    # its BNs sum the moments over 2 ranks
    per_rank.update(bn_train_fwd=0, bn_train_bwd=0, bn_batch_fwd=0, bn_batch_bwd=0)
    fed = launches(1, conv_bn_stats=37, conv_bn_stats_fp32=37, bn_train_fwd=37, bn_train_bwd=37,
                   bn_batch_fwd=24, bn_batch_bwd=24, resize=5, resize_row=1, resize_bwd=5,
                   resize_bwd_row=1)   # the steps on fed noise draw none
    fed_step = add_counts(fed, optimizer_launches(param_elems(), 1))
    for r in ranks:
        # TP's step: its own norm (a collective), the update launch over its shards
        tp_step = add_counts(fed, launches(1, clip_adamw_update=1,
                                           clip_adamw_elems=r["tp_elems"]))
        check(r["dp_counts"] == per_rank and r["explicit_counts"] == fed_step
              and r["tp_counts"] == tp_step,
              f"rank {r['rank']}: step launches {r['dp_counts']} / {r['explicit_counts']} / "
              f"{r['tp_counts']} differ from the code's {per_rank} / {fed_step} / {tp_step}")
    del state
    torch.cuda.empty_cache()

    # the per-device step = its hand split: the halves' gradients and
    # statistics averaged, one AdamW step
    grads, stats, losses = [], [], []
    for r in range(2):
        rows = slice(r * PAR_BATCH // 2, (r + 1) * PAR_BATCH // 2)
        state = create_train_state(config, seed=0, device="cuda")
        aux = make_train_step(config, state.model).compute_gradients(
            state, images[rows], masks[rows], 0.001, eps=eps[:, rows])
        grads.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
        stats.append({k: v.clone() for k, v in state.model.state_dict().items()
                      if "running_" in k})
        losses.append(aux["loss"].item())
    state = create_train_state(config, seed=0, device="cuda")
    for k, p in state.model.named_parameters():
        p.grad = (grads[0][k] + grads[1][k]) / 2
    grads_held("(b) per-device step vs its hand split", r0["explicit_grads"],
               on_host(device_grads(state.model)), SPLIT_GRAD_LIMIT)
    state.optimizer.step()
    ref = host_state(state.model)
    ref.update({k: ((stats[0][k] + stats[1][k]) / 2).cpu() for k in stats[0]})
    log(f"(b) per-device step: loss {r0['explicit_loss']:.7f} vs the hand split's "
        f"{(losses[0] + losses[1]) / 2:.7f}")
    check(abs(r0["explicit_loss"] - (losses[0] + losses[1]) / 2) <= 1e-5,
          "the per-device step's loss differs from its hand split's")
    held_to_harness("(b) per-device step vs its hand split", r0["explicit_state"], ref, lr)
    del state, grads, stats
    torch.cuda.empty_cache()

    # the channel-sharded step = the unsharded step
    tb = slice(0, TP_BATCH)
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    aux = step.compute_gradients(state, images[tb], masks[tb], 0.001, eps=eps[:, tb])
    ref_grads = on_host(device_grads(state.model))
    state.optimizer.step()
    log(f"(b) TP step (model axis 2, min_channels {TP_MIN_CHANNELS}, {r0['tp_sharded']} convs "
        f"sharded), fp32 b{TP_BATCH}: loss {r0['tp_loss']:.7f} vs {aux['loss'].item():.7f}; "
        f"clip norm {r0['tp_norm']:.6g} vs the gathered gradient's {r0['tp_full_norm']:.6g}")
    check(abs(r0["tp_loss"] - aux["loss"].item()) <= 1e-5 + 2e-6 * abs(aux["loss"].item()),
          "the TP step's loss differs from the unsharded step's")
    grads_held("(b) TP step vs the unsharded step", r0["tp_grads"], ref_grads, SPLIT_GRAD_LIMIT)
    check(all(abs(r["tp_norm"] - r["tp_full_norm"]) <= 1e-5 * r["tp_full_norm"] for r in ranks),
          "the TP clip norm misses the sharded gradients' squares")
    held_to_harness("(b) TP step vs the unsharded step", r0["tp_state"], host_state(state.model),
                    lr)
    del state, step
    torch.cuda.empty_cache()

    # the plain UNet's TP gradient = the unsharded model's whose transposed
    # convs sum their input-channel halves as the ranks do (the same
    # function; against the unsharded sum order the training-mode gradient
    # moves as much as under any reordered sum: logged beside it)
    config_u = train_config(amp=False, model_type="basic", bilinear=False)
    sharded = r0["unet_tp_sharded"]
    check({"up1.up.weight", "up2.up.weight", "up3.up.weight"} <= set(sharded),
          f"the UNet's TP step did not shard up1-3's transposed convs: {sharded}")
    refs = {}
    for split in (True, False):
        state = create_train_state(config_u, seed=0, device="cuda")
        if split:
            hand_split(state.model, sharded)
        aux = make_train_step(config_u, state.model).compute_gradients(
            state, images[tb], masks[tb], 0.001)
        refs[split] = (aux["loss"].item(), on_host(device_grads(state.model)))
        del state
    log(f"(b) UNet TP step ({len(sharded)} weights sharded, up1-3.up row-parallel), fp32 "
        f"b{TP_BATCH}: loss {r0['unet_tp_loss']:.7f} vs {refs[True][0]:.7f} (hand split) / "
        f"{refs[False][0]:.7f} (unsharded); gradient vs the unsharded sum order, relative L2 "
        f"{rel_l2(r0['unet_tp_grads'], refs[False][1]):.3g}")
    check(abs(r0["unet_tp_loss"] - refs[False][0]) <= 1e-5 + 2e-6 * abs(refs[False][0]),
          "the UNet TP step's loss differs from the unsharded step's")
    grads_held("(b) UNet TP step vs its hand split", r0["unet_tp_grads"], refs[True][1],
               SPLIT_GRAD_LIMIT, head="outc.conv")
    unet_fed = launches(1, conv_bn_stats=18, conv_bn_stats_fp32=18, bn_train_fwd=18,
                        bn_train_bwd=18, bn_batch_fwd=12, bn_batch_bwd=12)
    for r in ranks:
        check(r["unet_tp_counts"] == unet_fed, f"rank {r['rank']}: UNet TP step launches "
              f"{r['unet_tp_counts']} differ from the code's {unet_fed}")
    del refs
    torch.cuda.empty_cache()

    # the sample-parallel ensemble and the tile-sharded prediction
    model = build_model(backbone="resnet34", latent_dim=32, latent_injection="all", seed=0,
                        device="cuda")
    randomize_bn_stats(model, seed=1)
    image, zs, big = inference_inputs("cuda")
    ref = decode_samples(model, image, zs, torch.device("cuda")).cpu()
    err = (r0["ensemble"] - ref).abs().max().item()
    log(f"(b) ensemble_sample_parallel, N={N_SAMPLES} at {ENSEMBLE_HW}^2: "
        f"{max(r['ensemble_s'] for r in ranks):.3f} s; max err vs the one-rank decode {err:.3g}")
    check(tuple(r0["ensemble"].shape) == (N_SAMPLES, ENSEMBLE_HW, ENSEMBLE_HW, 1)
          and err <= 1e-5, "the sample-parallel ensemble differs from the one-rank decode")
    ref = predict_with_patches(model, big, zs[:1], patch_size=PATCH, overlap=OVERLAP,
                               batch_size=TILE_BATCH).cpu()
    err = (r0["tiled"] - ref).abs().max().item()
    log(f"(b) predict_tiled_sharded, {IMAGE_HW[0]}x{IMAGE_HW[1]}: "
        f"{max(r['tiled_s'] for r in ranks):.3f} s; max err vs predict_with_patches {err:.3g}")
    check(tuple(r0["tiled"].shape) == (*IMAGE_HW, 1) and err <= 1e-5,
          "the tile-sharded prediction differs from predict_with_patches")
    del model
    torch.cuda.empty_cache()
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return total


# ----- phase 16 ------------------------------------------------------------

PRETRAIN_BATCH, PRETRAIN_STEPS = 8, 3
# per step at 512^2: the encoder's 29 stride-1 conv + BN pairs; its 7
# other BNs (the stem, the strided convs', the downsamples') and the masked
# head's 5 on the bn_batch kernels; the masked head's 5 upsamples and its
# resize to the input, forward and backward; the contrastive views' two
# noise draws
PRETEXT_LAUNCHES = {"masked": dict(conv_bn_stats=29, bn_train_fwd=29, bn_train_bwd=29,
                                   bn_batch_fwd=12, bn_batch_bwd=12, resize=6, resize_bwd=6),
                    "contrastive": dict(conv_bn_stats=29, bn_train_fwd=29, bn_train_bwd=29,
                                        bn_batch_fwd=7, bn_batch_bwd=7, normal=2)}


def phase_pretrain(root: Path) -> dict:
    """Encoder pretraining and the profiling helpers on the card: both
    pretexts at full width (resnet34, 512^2, batch 8, bf16), 3 steps each,
    every parameter moved and finite and the launches held; ``cli.pretrain``
    for one epoch on phase 13's set; ``cli.train --pretrained-encoder``
    starting from that encoder bit for bit; ``time_fn``, ``track_memory``
    and ``trace`` once each.  -> the phase's launch counts."""
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["VAEUNET_CACHE_DIR"] = str(root / "cache")
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    total = launches()
    elems = {}
    g = torch.Generator(device="cuda").manual_seed(13)
    images = torch.rand((PRETRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), device="cuda", generator=g)
    for pretext in ("masked", "contrastive"):
        model = build_pretrain_model(pretext, "resnet34", seed=0, device="cuda")
        state = create_pretrain_state(model, 1e-3, seed=0)
        step = (make_pretrain_step(model) if pretext == "masked"
                else make_contrastive_step(model))
        before = {k: v.detach().clone() for k, v in model.named_parameters()}

        def run():
            return [step(state, images)[1].item() for _ in range(PRETRAIN_STEPS)]

        losses, counts, sec = counted(run)
        elems[pretext] = sum(p.numel() for p in model.parameters())
        expected = add_counts(launches(PRETRAIN_STEPS, **PRETEXT_LAUNCHES[pretext]),
                              optimizer_launches(elems[pretext], PRETRAIN_STEPS))
        still = [k for k, p in model.named_parameters() if torch.equal(p.detach(), before[k])]
        finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
        log(f"{pretext} pretext, resnet34 512^2 b{PRETRAIN_BATCH} bf16: {PRETRAIN_STEPS} steps "
            f"in {sec:.3f} s (the first cold), losses {[round(v, 5) for v in losses]}; "
            f"unmoved {still or 'none'}; launches {counts}  expected {expected}  [{smi}]")
        check(finite and not still and all(np.isfinite(losses)),
              f"{pretext} pretext: parameters {still} unmoved or not finite")
        check(counts == expected, f"{pretext} pretext launches {counts} differ from {expected}")
        total = {k: total[k] + counts[k] for k in total}
        if pretext == "masked":
            # the input bytes of every training BN the model calls (the fused
            # sites call `forward_fused`, not the module)
            bn_inputs = []
            hooks = [m.register_forward_pre_hook(
                         lambda m, args: bn_inputs.append(args[0].numel() * args[0].element_size())
                         if m.training else None)
                     for m in model.modules() if isinstance(m, BatchNorm)]

            def profile():
                mean_s = profiling.time_fn(lambda: step(state, images), iters=3, warmup=1)
                bn_inputs.clear()
                with profiling.trace(str(root / "trace")) as trace_path:
                    step(state, images)
                    torch.cuda.synchronize()
                traced = list(bn_inputs)
                loss = profiling.track_memory(lambda: step(state, images)[1].item())()
                return mean_s, trace_path, loss, traced

            profiling.clear_spans()
            try:
                (mean_s, trace_path, loss, traced), counts, _ = counted(profile)
            finally:
                for h in hooks:
                    h.remove()
            size = Path(trace_path).stat().st_size
            # the one traced step counts its calls and their host time, and
            # the bytes of the training BNs it ran on the bn_batch kernels
            # (none on torch's ops)
            one = add_counts(launches(**PRETEXT_LAUNCHES[pretext]),
                             optimizer_launches(elems[pretext]))
            expected = launches(6, **one)
            expected["ext_calls"] = ext_calls(one)
            expected["bn_batch_bytes"] = sum(traced)
            got = {k: v for k, v in counts.items() if k != "ext_call_ns"}
            expected.pop("ext_call_ns")
            recorded = [s.name for s in profiling.spans()]
            log(f"profiling: time_fn {mean_s:.4f} s a masked step (each window ends in a "
                f"synchronize); track_memory ran one (loss {loss:.5f}, "
                f"{profiling.device_memory_mb():.0f} MB allocated); trace {trace_path}, {size} "
                f"bytes; launches of the 6 steps {counts}  expected {expected} (ext_call_ns "
                f"aside; bn_batch_bytes from the BN modules' calls in the traced step); spans of "
                f"the traced step {recorded}")
            check(size > 0 and mean_s > 0, "the profiling helpers wrote or timed nothing")
            check(got == expected and counts["ext_call_ns"] > 0 and len(traced) == 12
                  and counts["bn_batch_bytes"] > 0,
                  f"profiled steps' launches {counts} differ from {expected}")
            total = {k: total[k] + counts[k] for k in total}
        del model, state, step, before
        torch.cuda.empty_cache()

    data = str(root / "idrid")
    out = root / "encoder_ssl"
    ds = IDRIDDataset(data, split="train", scale=LOOP_SCALE, patch_size=TRAIN_HW,
                      lesion_type="EX", balance_seed=0)
    steps = len(ds) // PRETRAIN_BATCH
    with in_dir(root):
        path, counts, sec = counted(lambda: pretrain_cli.main(
            ["--data-dir", data, "--scale", str(LOOP_SCALE), "--patch-size", str(TRAIN_HW),
             "--batch-size", str(PRETRAIN_BATCH), "--epochs", "1", "--out", str(out)]))
        expected = add_counts(launches(steps, **PRETEXT_LAUNCHES["masked"]),
                              optimizer_launches(elems["masked"], steps))
        log(f"cli.pretrain: one epoch of {steps} masked steps on {len(ds)} patches in "
            f"{sec:.1f} s (dataset and cache included); {path}; launches {counts}  expected "
            f"{expected}")
        check(counts == expected, f"cli.pretrain launches {counts} differ from {expected}")
        total = {k: total[k] + counts[k] for k in total}
        enc = torch.load(path, map_location="cpu", weights_only=True)
        state = train_cli.main(["--data-dir", data, "--scale", str(LOOP_SCALE), "--patch-size",
                                str(TRAIN_HW), "--batch-size", str(TRAIN_BATCH),
                                "--gradient-accumulation-steps", "1", "--epochs", "0",
                                "--checkpoint-dir", str(root / "ckpt_ssl"),
                                "--pretrained-encoder", str(out)])
    got = host_state(state.model)
    same = bool(enc) and all(torch.equal(got[k], v) for k, v in enc.items())
    log(f"cli.train --pretrained-encoder: {len(enc)} encoder tensors, equal bit for bit: {same}")
    check(same, "the train CLI did not start from the pretrained encoder")
    del state
    torch.cuda.empty_cache()
    log(f"pretraining phase: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return total


# ----- phase 17 ------------------------------------------------------------

# the members of the ensemble tools: phase 13's run dir at scale 0.5 and
# phase 14's .pth of the same weights at 1.0 with the h-flip
ENSEMBLE_SPLITS = ("val", "test")
T0_SCALE, T0_SAMPLES = 0.25, 2      # the card-against-CPU map (T = 0: the samples agree)
SWEEP_SEED = 31                     # its first two trials: batch 2, scale 0.25, patch 256
SWEEP_TRIALS, SWEEP_IMAGES = 2, 2


def resize_launches(in_hw, out_hw, batch: int) -> dict:
    """One fp32 C = 1 resize to the ground truth (align_corners=False): the
    row kernel where ``resize_mm.plan_forward`` routes it there."""
    row = resize_mm.plan_forward(in_hw, out_hw, 1, 4, False, batch).route == "row"
    return launches(resize=1, resize_row=int(row))


def member_image_launches(hw, gt_hw, samples: int = N_SAMPLES) -> dict:
    """One member-image of ``cli.member_maps``: the tiled request at the
    adaptive overlap, and the samples' resize to the ground truth."""
    request = request_launches(hw, TILE_BATCH, samples, overlap=adaptive_overlap(PATCH))
    if tuple(hw) == tuple(gt_hw):
        return request
    return add_counts(request, resize_launches(hw, gt_hw, samples))


def scale_member_launches(hw, gt_hw) -> dict:
    """One member-image of ``cli.scale_ensemble``: as ``cli.member_maps``'s,
    and off the ground truth's size one resize more (the mean's)."""
    own = member_image_launches(hw, gt_hw)
    return own if tuple(hw) == tuple(gt_hw) else add_counts(own, resize_launches(hw, gt_hw, 1))


def finite_csv(path: Path, rows: int) -> pd.DataFrame:
    csv = pd.read_csv(path)
    columns = ["img_id", "dice", "ece", "sparsification_error", "uncertainty_error_dice",
               "error_auroc", "error_auprc"]
    check(list(csv.columns) == columns and len(csv) == rows,
          f"{path}: {len(csv)} rows, columns {list(csv.columns)}")
    check(bool(np.isfinite(csv[columns[1:]].to_numpy(dtype=np.float64)).all()),
          f"{path}: non-finite values")
    return csv


def phase_ensemble_tools(root: Path) -> dict:
    """The ensemble protocol's tools, the offline sweep and the two benchmark
    entry points on phase 13's tree (its val split and phase 14's test
    split, 2 fundi each at 2848x4288): ``cli.member_maps`` with phase 13's
    run dir at 0.5 and phase 14's .pth of the same weights at 1.0 with the
    h-flip, N=10, T=1, tiles 512, on both splits (files present and
    finite, mom[0] / N the map, a second call writes nothing, launches
    held), one fundus at 0.25 and T = 0 on the card against the CPU (atol
    2e-4, its launches held); ``cli.tune_fusion`` greedy on the val maps and
    its point frozen onto the test maps; ``cli.scale_ensemble`` of the two
    members with the CSV (launches held, 11 mixing weights); ``cli.sweep``,
    2 one-epoch trials; ``cli.bench`` and ``cli.bench_tiled`` at their
    defaults (launches held).  -> the phase's launch counts."""
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["VAEUNET_CACHE_DIR"] = str(root / "cache")
    use_fp32_numerics()
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    total = launches()
    data = root / "idrid"
    run_dir = loop_config(root).checkpoint_path()
    pth = root / "flagship.pth"                     # phase 14's, the run dir's weights
    check(pth.is_file(), f"{pth} is missing")
    members = [f"run={run_dir}@0.5", f"pth={pth}@1.0:h"]
    maps = root / "maps"

    # 1. member maps on both splits
    for split in ENSEMBLE_SPLITS:
        report: dict = {}
        args = ["--member", members[0], "--member", members[1], "--lesion-type", "EX",
                "--split", split, "--outdir", str(maps / split), "--data-dir", str(data),
                "--samples", str(N_SAMPLES), "--temperature", str(TEMPERATURE),
                "--patch-size", str(PATCH)]
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        out = member_maps_cli.main(args, report=report)
        maps_s = time.perf_counter() - t0
        expected = add_counts(*(member_image_launches(m["hw"], m["gt_hw"])
                                for m in report["maps"]))
        total = add_counts(total, step_counts(f"member maps ({split})", expected, smi))
        for m in report["maps"]:
            log(f"member map {split} {m['label']} {m['img_id']} ({m['hw'][0]}x{m['hw'][1]} -> "
                f"{m['gt_hw'][0]}x{m['gt_hw'][1]}, N={N_SAMPLES}, tiles {PATCH}/"
                f"{adaptive_overlap(PATCH)}): {m['seconds']:.3f} s request to saved map  "
                f"[{smi}]")
        log(f"member maps ({split}): {len(out['written'])} maps in {maps_s:.1f} s  [{smi}]")
        check(len(out["written"]) == 2 * 2 and not out["skipped"], f"maps written {out}")
        for gt_file in sorted((maps / split).glob("gt_*.npy")):
            img = gt_file.stem[3:]
            gt = np.load(gt_file)
            for label in ("run", "pth"):
                prob = np.load(maps / split / f"{label}_{img}.npy")
                mom = np.load(maps / split / f"{label}_{img}_mom.npy")
                check(prob.shape == gt.shape == mom.shape[1:] and mom.shape[0] == 2,
                      f"{label} {img}: map {prob.shape}, mom {mom.shape}, gt {gt.shape}")
                check(bool(np.isfinite(prob).all() and np.isfinite(mom).all()),
                      f"{label} {img}: non-finite map")
                err = float(np.abs(mom[0] / N_SAMPLES - prob).max())
                check(err <= 1e-6, f"{label} {img}: mom[0] / N differs from the map by {err}")
        before = {p.name: p.stat().st_mtime_ns for p in (maps / split).iterdir()}
        _ext.reset_launch_counts()
        again = member_maps_cli.main(args)
        check(again["written"] == [] and len(again["skipped"]) == 4, f"second call {again}")
        check({p.name: p.stat().st_mtime_ns for p in (maps / split).iterdir()} == before,
              "the second member-maps call wrote a file")
        step_counts(f"member maps ({split}, resumed)", launches(), smi)

    # 2. one member-image at T = 0: the card against the CPU
    t0_maps = {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        report = {}
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        member_maps_cli.main(["--member", f"t0={run_dir}@{T0_SCALE}", "--lesion-type", "EX",
                              "--split", "val", "--outdir", str(root / f"maps_t0_{where}"),
                              "--data-dir", str(data), "--samples", str(T0_SAMPLES),
                              "--temperature", "0", "--patch-size", str(PATCH),
                              "--images", "IDRiD_00", "--device", device], report=report)
        [m] = report["maps"]
        if where == "card":
            total = add_counts(total, step_counts(
                "one member-image", member_image_launches(m["hw"], m["gt_hw"], T0_SAMPLES), smi))
        t0_maps[where] = np.load(root / f"maps_t0_{where}" / "t0_IDRiD_00.npy")
        log(f"member map at T = 0 on the {where} ({m['hw'][0]}x{m['hw'][1]} -> "
            f"{m['gt_hw'][0]}x{m['gt_hw'][1]}, N={T0_SAMPLES}): "
            f"{time.perf_counter() - t0:.1f} s  [{smi}]")
    err = float(np.abs(t0_maps["card"] - t0_maps["host"]).max())
    log(f"member map at T = 0, card against CPU: max |diff| {err:.3g} (limit 2e-4)")
    check(err <= 2e-4, f"the card's T = 0 map differs from the CPU's by {err} > 2e-4")

    # 3. tuning on val, the point frozen onto test
    t0 = time.perf_counter()
    tuned = tune_fusion_cli.main(["--val-dir", str(maps / "val"), "--test-dir",
                                  str(maps / "test"), "--output-dir", str(root / "tuned"),
                                  "--samples-per-member", str(N_SAMPLES), "--cache-maps"])
    tune_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frozen = tune_fusion_cli.main(["--val-dir", str(maps / "val"), "--test-dir",
                                   str(maps / "test"), "--output-dir", str(root / "frozen"),
                                   "--samples-per-member", str(N_SAMPLES), "--point-json",
                                   str(root / "tuned" / "operating_point.json")])
    frozen_s = time.perf_counter() - t0
    finite_csv(frozen["csv"], 2)
    log(f"tune_fusion greedy on val + apply to test: {tune_s:.1f} s, point "
        f"{json.dumps(tuned['point'])}; the frozen point on test: {frozen_s:.1f} s, mean Dice "
        f"{frozen['mean_dice']:.4f}  [{smi}]")
    check(frozen["point"] == tuned["point"] and frozen["rows"] == tuned["rows"],
          "the frozen point's CSV differs from the tuning run's")

    # 4. the scale ensemble with the CSV
    report = {}
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    ens = scale_ensemble_cli.main([
        "--member", f"{run_dir}@0.5", "--member", f"{pth}@1.0", "--lesion-type", "EX",
        "--data-dir", str(data), "--samples", str(N_SAMPLES), "--patch-size", str(PATCH),
        "--output-dir", str(root / "scale_ensemble")], report=report)
    ens_s = time.perf_counter() - t0
    expected = add_counts(*(scale_member_launches(r["hw"], r["gt_hw"])
                            for r in report["requests"]))
    total = add_counts(total, step_counts("scale ensemble", expected, smi))
    finite_csv(ens["csv"], 2)
    for r in report["requests"]:
        log(f"scale ensemble {r['img_id']} ({r['hw'][0]}x{r['hw'][1]} -> {r['gt_hw'][0]}x"
            f"{r['gt_hw'][1]}): request and resizes {r['seconds']:.3f} s  [{smi}]")
    log(f"scale ensemble: {ens_s:.1f} s, fused Dice {ens['fused_dice']}, mixing sweep "
        f"{ {k: [round(d, 3) for d in v] for k, v in ens['pair'].items()} }  [{smi}]")
    check(len(ens["pair"]) == 2 and all(len(v) == 11 for v in ens["pair"].values()),
          f"mixing sweep {ens['pair']}")

    # 5. the offline sweep
    (root / "sweep").mkdir()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    with in_dir(root / "sweep"):                     # ./runs, ./checkpoints, the results
        results = sweep_cli.main(["--trials", str(SWEEP_TRIALS), "--data-dir", str(data),
                                  "--max-epochs", "1", "--max-images", str(SWEEP_IMAGES),
                                  "--seed", str(SWEEP_SEED)])
    sweep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = _ext.launch_counts()
    total = add_counts(total, counts)
    records = [json.loads(ln) for ln in
               (root / "sweep" / "sweep_results.jsonl").read_text().splitlines()]
    for rec in records:
        log(f"sweep trial {rec['trial']}: {json.dumps(rec)}  [{smi}]")
    log(f"sweep: {SWEEP_TRIALS} trials in {sweep_s:.1f} s, launches {counts}  [{smi}]")
    check(len(records) == len(results) == SWEEP_TRIALS
          and all(r["status"] == "ok" for r in records), f"sweep records {records}")
    for k in ("conv_bn_stats", "bn_train_fwd", "bn_train_bwd", "bn_batch_fwd", "bn_batch_bwd",
              "resize_bwd", "normal", "bn_relu", "clip_adamw_norm", "clip_adamw_update"):
        check(counts[k] > 0, f"the sweep's training launched no {k}")

    # 6. the two benchmark entry points at their defaults
    report = {}
    _ext.reset_launch_counts()
    line = bench_cli.main([], report=report)
    total = add_counts(total, step_counts(
        "bench", expected_train_launches(bench_cli.WARMUP + bench_cli.STEPS), smi))
    log(f"bench: {json.dumps(line)}; step p50 {statistics.median(report['step_s']):.4f} s  "
        f"[{smi}]")
    check(line["value"] > 0 and all(v == v for v in report["loss"]), f"bench {line}")
    report = {}
    _ext.reset_launch_counts()
    line = bench_tiled_cli.main([], report=report)
    hw = (bench_tiled_cli.H, bench_tiled_cli.W)
    per_run = tiled_decodes(hw, bench_tiled_cli.TILE_BATCH, 1, adaptive_overlap(PATCH))
    total = add_counts(total, step_counts(
        "bench_tiled", add_counts(*[per_run] * (1 + bench_tiled_cli.RUNS)), smi))
    log(f"bench_tiled: {json.dumps(line)}; all {[round(t, 4) for t in report['latency_s']]} s  "
        f"[{smi}]")
    check(line["tiles"] == len(compute_tile_grid(*hw, PATCH)) and line["value"] > 0,
          f"bench_tiled {line}")
    torch.cuda.empty_cache()
    log(f"ensemble tools, sweep and bench phase: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
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
    # the fp32 and the bf16 Ci <= 8 kernels of the same wrapper, and the
    # one-channel kernel of the resize's
    ("conv_bn_stats_fp32", "vaeunet_tpu_torch/csrc/conv_bn_stats.cu",
     "vaeunet_tpu/ops/pallas/conv_bn_stats.py:112"),
    ("conv_bn_stats_ci8", "vaeunet_tpu_torch/csrc/conv_bn_stats.cu",
     "vaeunet_tpu/ops/pallas/conv_bn_stats.py:112"),
    ("resize_c1", "vaeunet_tpu_torch/csrc/resize.cu", "vaeunet_tpu/ops/pallas/resize_mm.py:70,98"),
    ("resize_bwd_c1", "vaeunet_tpu_torch/csrc/resize.cu",
     "vaeunet_tpu/ops/pallas/resize_mm.py:125-151"),
    # no Pallas kernel: the JAX package leaves the training BN to XLA
    ("bn_train_fwd", "vaeunet_tpu_torch/csrc/bn_train.cu", "none"),
    ("bn_train_bwd", "vaeunet_tpu_torch/csrc/bn_train.cu", "none"),
    ("bn_batch_fwd", "vaeunet_tpu_torch/csrc/bn_train.cu", "none"),
    ("bn_batch_bwd", "vaeunet_tpu_torch/csrc/bn_train.cu", "none"),
    # no Pallas kernel: the JAX package leaves optax's clip and adamw to XLA
    ("clip_adamw", "vaeunet_tpu_torch/csrc/clip_adamw.cu", "none"),
)
# entry of the kernels line -> its launch counter where the names differ
COUNTERS = {"resize_c1": "resize_row", "resize_bwd_c1": "resize_bwd_row",
            "clip_adamw": "clip_adamw_update"}
# wrapper -> the counter of its second kernel, whose launches it also counts
OTHER_KERNEL = {"resize": "resize_row", "resize_bwd": "resize_bwd_row",
                "conv_bn_stats": "conv_bn_stats_fp32"}


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
    with tempfile.TemporaryDirectory() as tmp:
        path_counts.append(phase_loop(Path(tmp)))
        log(f"phase 13: {time.perf_counter() - t_start:.1f} s")
        path_counts.append(phase_analysis(Path(tmp)))
        log(f"phase 14: {time.perf_counter() - t_start:.1f} s")
        path_counts.append(phase_parallel())
        log(f"phase 15: {time.perf_counter() - t_start:.1f} s")
        path_counts.append(phase_pretrain(Path(tmp)))
        log(f"phase 16: {time.perf_counter() - t_start:.1f} s")
        path_counts.append(phase_ensemble_tools(Path(tmp)))
        log(f"phase 17: {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, source, replaces in KERNELS:
        rec = table[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path_launches(name, *path_counts),
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"], "shape": rec["shape"],
                        **{k: rec[k] for k in ("augmentation_shape", "pretext_shape",
                                               "small_ci_shape", "launch_ms",
                                               "replaced_wgmma_ms", "scalar_ms", "device_ms")
                           if k in rec},
                        **({"wrapper_ms": rec["wrapper_ms"]} if "wrapper_ms" in rec else {})})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
