#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``vaeunet_tpu_torch``) on the card, in
phases that each fail the run with a non-zero exit:

1. device: name, count, versions, ``nvidia-smi`` name and power limit;
2. build: every ``vaeunet_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the serving path's shapes, with timings (CUDA events) beside the
   bytes bound and a PyTorch yardstick;
4. the slice: the full-width resnet34 VAE-UNet (random weights from a seed,
   randomized BN statistics) answers 3 uncertainty requests on a 2848x4288
   image, 512 tiles with overlap 100, N=10 samples at T=1, plus one sampled
   ``predict_image`` at 512^2.  Kernel launch counts are read over exactly
   this phase and held against the counts the code implies;
5. the card's slice against the CPU's on one 512^2 image, same weights and
   noise, TF32 off: samples atol 2e-4, mu/logvar atol 1e-4.

The serving path and every comparison run in full fp32 (TF32 off for
cuDNN convolutions and matmuls).  The last three lines are the kernels JSON,
the ``nvidia-smi`` line and the result JSON.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch import build_model, predict_image, segmentation_distribution
from vaeunet_tpu_torch import uncertainty_maps, use_fp32_numerics
from vaeunet_tpu_torch.inference.tiled import compute_tile_grid
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu as bn_relu_mod
from vaeunet_tpu_torch.ops.pallas import reparam as reparam_mod
from vaeunet_tpu_torch.ops.pallas import resize_mm

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores

IMAGE_HW = (2848, 4288)       # one IDRiD fundus at full resolution
PATCH, OVERLAP, TILE_BATCH = 512, 100, 8
N_SAMPLES, TEMPERATURE = 10, 1.0
N_REQUESTS = 3
# scalar operations per element, for the operations bound
PHILOX_BOX_MULLER_OPS = 146   # 10 Philox rounds (~100 integer ops) + uniforms + log/sqrt/cos
BN_RELU_OPS = 3               # mul, add, max
RESIZE_OPS = 9                # 3 lerps of (sub, mul, mul, add) sharing the (1 - lambda)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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


def kernel_bn_relu(table: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((8, 64, 256, 256), (8, 512, 16, 16)):
        c = shape[1]
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g)
        mean = torch.randn(c, device="cuda", generator=g) * 0.5
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        a, b = bn_relu_mod.fold(scale, bias, mean, var)
        for dtype in (torch.float32, torch.bfloat16):
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


RESIZE_SHAPES = (((8, 512, 16, 16), 32), ((8, 512, 32, 32), 64), ((8, 256, 64, 64), 128),
                 ((8, 128, 128, 128), 256), ((8, 1, 256, 256), 512))


def kernel_resize(table: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(2)
    for shape, out in RESIZE_SHAPES:
        for ac in (True, False):
            x = torch.randn(shape, device="cuda", generator=g).contiguous(
                memory_format=torch.channels_last)
            y = resize_mm.resize(x, (out, out), ac)
            ref = resize_mm.resize_plain(x, (out, out), ac)
            lib = F.interpolate(x, size=(out, out), mode="bilinear", align_corners=ac)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            err_lib = (y - lib).abs().max().item()
            check(err <= 1e-6, f"resize {shape}->{out} ac={ac}: err {err} > 1e-6")
            check(err_lib <= 1e-5, f"resize {shape}->{out} ac={ac}: "
                  f"err vs F.interpolate {err_lib} > 1e-5")
            nbytes = (x.numel() + y.numel()) * 4
            it = iters_for(nbytes)
            k_ms = time_ms(lambda: resize_mm.resize(x, (out, out), ac), it)
            p_ms = time_ms(lambda: resize_mm.resize_plain(x, (out, out), ac), it)
            l_ms = time_ms(lambda: F.interpolate(x, size=(out, out), mode="bilinear",
                                                 align_corners=ac), it)
            bnd, by = bound_ms(nbytes, RESIZE_OPS * y.numel())
            log(f"resize {list(shape)}->{out}^2 ac={ac}: err {err:.3g} (vs F.interpolate "
                f"{err_lib:.3g})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
                f"F.interpolate {l_ms:.4f} ms  bound {bnd:.4f} ms")
            main = shape == (8, 128, 128, 128) and ac
            _record(table, "resize", err=err, **(dict(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
                shape=f"{list(shape)}->{out}^2 fp32") if main else {}))
    # bf16 with fp32 blending: against the plain version, within one bf16 ulp
    x = torch.randn((8, 128, 128, 128), device="cuda", generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    y = resize_mm.resize(x, (256, 256), True).float()
    ref = resize_mm.resize_plain(x, (256, 256), True).float()
    torch.cuda.synchronize()
    check(((y - ref).abs() <= ref.abs() * 2.0 ** -7).all().item(),
          "resize bf16: differs from the plain version by more than 1 ulp")
    log(f"resize bf16 [8,128,128,128]->256^2: max err {(y - ref).abs().max().item():.3g}")


def kernel_noise(table: dict) -> None:
    for shape in ((8192, 64), (3, 32), (1, 32)):
        z = reparam_mod.normal(shape, 11, "cuda")
        ref = reparam_mod.normal_plain(shape, 11, "cuda")
        torch.cuda.synchronize()
        err = (z - ref).abs().max().item()
        check(err <= 1e-5, f"normal {shape}: err {err} vs plain > 1e-5")
        check(torch.equal(z, reparam_mod.normal(shape, 11, "cuda")),
              f"normal {shape}: same seed gave different values")
        check(not torch.equal(z, reparam_mod.normal(shape, 12, "cuda")),
              f"normal {shape}: a new seed gave the same values")
        if shape == (8192, 64):
            m, s = z.mean().item(), z.std().item()
            check(abs(m) < 0.01 and abs(s - 1) < 0.01, f"normal moments {m} {s}")
            log(f"normal [8192, 64]: mean {m:.5f} std {s:.5f}")
        n = z.numel()
        it = 200
        k_ms = time_ms(lambda: reparam_mod.normal(shape, 11, "cuda"), it)
        p_ms = time_ms(lambda: reparam_mod.normal_plain(shape, 11, "cuda"), it)
        l_ms = time_ms(lambda: torch.randn(shape, device="cuda"), it)
        bnd, by = bound_ms(4 * n, PHILOX_BOX_MULLER_OPS * n)
        log(f"normal {list(shape)}: err {err:.3g}  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"torch.randn {l_ms:.4f} ms  bound {bnd:.6f} ms")
        main = shape == (1, 32)
        _record(table, "normal", err=err, **(dict(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bnd, bound_by=by,
            shape="[1, 32]") if main else {}))


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
    bnd, by = bound_ms(12 * n, (PHILOX_BOX_MULLER_OPS + 5) * n)
    log(f"reparam [10, 32]: err {err:.3g}  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
        f"bound {bnd:.6f} ms")
    _record(table, "reparam", err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
            bound_ms=bnd, bound_by=by, shape="[10, 32]")


def phase_kernels() -> dict:
    table: dict = {}
    kernel_bn_relu(table)
    kernel_resize(table)
    kernel_noise(table)
    kernel_reparam(table)
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
    per_request = {"bn_relu": enc * (1 + batches) + dec * batches * N_SAMPLES,
                   "resize": 5 * batches * N_SAMPLES, "reparam": 1, "normal": 0}
    expected = {k: v * N_REQUESTS for k, v in per_request.items()}
    expected["bn_relu"] += enc + dec        # one predict_image at 512^2
    expected["resize"] += 5
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
    for k, v in counts.items():
        check(v > 0, f"kernel {k} was not launched on the serving path")
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


KERNELS = (
    ("normal", "vaeunet_tpu_torch/csrc/reparam.cu", "vaeunet_tpu/ops/pallas/reparam.py:53"),
    ("reparam", "vaeunet_tpu_torch/csrc/reparam.cu", "vaeunet_tpu/ops/pallas/reparam.py:87"),
    ("bn_relu", "vaeunet_tpu_torch/csrc/bn_relu.cu", "vaeunet_tpu/ops/pallas/bn_relu.py:30"),
    ("resize", "vaeunet_tpu_torch/csrc/resize.cu", "vaeunet_tpu/ops/pallas/resize_mm.py:70,98"),
)


def main() -> None:
    t_start = time.perf_counter()
    device = phase_device()
    use_fp32_numerics()
    phase_build()
    table = phase_kernels()
    model = build_model(backbone="resnet34", latent_dim=32, latent_injection="all",
                        seed=0, device="cuda")
    randomize_bn_stats(model, seed=1)
    counts = phase_slice(model)
    phase_parity(model)
    kernels = []
    for name, source, replaces in KERNELS:
        rec = table[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"], "shape": rec["shape"]})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)


if __name__ == "__main__":
    main()
