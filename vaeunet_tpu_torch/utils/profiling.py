"""Where a serving request's or a training step's device time goes.  Port
of the tracing role of ``vaeunet_tpu/utils/profiling.py`` (its ``trace``
context manager around ``jax.profiler``), here over ``torch.profiler``.

    python -m vaeunet_tpu_torch.utils.profiling            # one request
    python -m vaeunet_tpu_torch.utils.profiling --train    # one train step
    python -m vaeunet_tpu_torch.utils.profiling --train --fp32   # ... with amp=False
    python -m vaeunet_tpu_torch.utils.profiling --train --model unet   # another model

runs, after a warm-up, one N-sample uncertainty request (the
full-resolution tiled request of ``chip_smoke.py``), or one warm training
step (the 512^2 batch-16 bf16 step of ``chip_smoke.py`` phase 6, or with
``--fp32`` its fp32 form with TF32 off, phase 7; ``--model`` picks the
resnet34 VAE-UNet, the plain UNet of either ``bilinear`` setting or the
resnet50 VAE-UNet with deep supervision, phases 10 and 11), under
``torch.profiler`` on the card and prints the device time by kernel family
and the top kernels, the wall time, and the device's idle share (1 - summed
kernel time / wall time; one stream, so kernels do not overlap).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from typing import Callable, Dict

import torch

from vaeunet_tpu_torch import build_model, segmentation_distribution, uncertainty_maps
from vaeunet_tpu_torch import use_fp32_numerics
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("conv_bn_stats (this port's kernel)", ("conv3x3_stats_f32_kernel",
                                            "conv3x3_stats_wgmma_kernel",
                                            "reduce_partials_kernel")),
    ("bn_relu", ("bn_relu_",)),
    ("resize_bwd (this port's kernel)", ("resize_bwd_tiled_kernel", "resize_bilinear_bwd_kernel")),
    ("resize", ("resize_tiled_kernel", "resize_row_kernel", "resize_bilinear_kernel")),
    ("normal/reparam", ("normal_kernel", "reparam_kernel")),
    ("optimizer (foreach AdamW, clip)", ("multi_tensor_apply", "adam")),
    ("batch_norm (gate, residual)", ("batch_norm", "bn_fw_inf")),
    ("convolution (cuDNN)", ("conv", "xmma", "cudnn", "implicit_gemm", "cutlass", "sm90_",
                             "winograd", "fft", "DSE::", "pointwise_mult_and_sum_complex",
                             "gemm", "nchwToNhwc", "nhwcToNchw")),
    ("copy / cat / fill", ("copy", "Cat", "cat_", "fill", "Memcpy", "Memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other elementwise / reduction"


def device_breakdown(fn: Callable[[], None]) -> Dict:
    """Run fn() once under torch.profiler; -> wall seconds, summed device
    seconds, per-family and per-kernel device seconds and launch counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        # annotation spans on the device timeline (e.g. Optimizer.step)
        # cover kernels counted on their own; they are not kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            rec = per_kernel[e.name]
            rec[0] += e.time_range.elapsed_us() * 1e-6
            rec[1] += 1
    per_family = defaultdict(lambda: [0.0, 0])
    for name, (sec, n) in per_kernel.items():
        rec = per_family[family(name)]
        rec[0] += sec
        rec[1] += n
    busy = sum(sec for sec, _ in per_kernel.values())
    return {"wall_s": wall, "device_s": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None,
            "families": dict(per_family), "kernels": dict(per_kernel)}


def serving_request() -> Callable[[], None]:
    model = build_model(seed=0, device="cuda")
    # one IDRiD fundus at full resolution; 512 tiles, overlap 100, N=10
    image = torch.rand((2848, 4288, 3), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(4))

    def request():
        samples, _, _ = segmentation_distribution(
            model, image, torch.Generator().manual_seed(0), num_samples=10,
            patch_size=512, overlap=100)
        uncertainty_maps(samples)

    return request


# --model -> the config fields of its step
MODELS = {
    "vaeunet": dict(model_type="resnet"),
    "unet": dict(model_type="basic"),
    "unet_bilinear": dict(model_type="basic", bilinear=True),
    "resnet50_ds": dict(model_type="resnet", backbone="resnet50", deep_supervision=True),
}


def train_step(amp: bool = True, model: str = "vaeunet") -> Callable[[], None]:
    config = TrainConfig(batch_size=16, gradient_accumulation_steps=1, amp=amp,
                         patch_size=512, learning_rate=1e-4, **MODELS[model])
    state = create_train_state(config, seed=0, device="cuda")
    step = make_train_step(config, state.model)
    g = torch.Generator(device="cuda").manual_seed(9)
    images = torch.rand((16, 512, 512, 3), device="cuda", generator=g)
    masks = (torch.rand((16, 512, 512, 1), device="cuda", generator=g) > 0.9).float()

    def run():
        _, aux = step(state, images, masks, 0.001)
        aux["loss"].item()

    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train", action="store_true",
                        help="profile one warm 512^2 batch-16 bf16 training step")
    parser.add_argument("--fp32", action="store_true",
                        help="with --train: amp=False and TF32 off, the fp32 conv kernel's path")
    parser.add_argument("--model", choices=sorted(MODELS), default="vaeunet",
                        help="with --train: the model of the step (default the resnet34 "
                             "VAE-UNet)")
    args = parser.parse_args()
    if (args.fp32 or args.model != "vaeunet") and not args.train:
        parser.error("--fp32 and --model go with --train")
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    if args.fp32:
        use_fp32_numerics()
    fn = train_step(amp=not args.fp32, model=args.model) if args.train else serving_request()
    fn()                                           # warm-up: library load, cuDNN plans
    if args.train:
        fn()
    out = device_breakdown(fn)
    what = (f"{'fp32 (TF32 off)' if args.fp32 else 'bf16'} {args.model} train step, 512^2 "
            f"batch 16" if args.train else "fp32 request, TF32 off")
    print(f"device: {torch.cuda.get_device_name(0)}  ({what})")
    print(f"wall {out['wall_s']:.3f} s  device busy {out['device_s']:.3f} s  "
          f"idle share {out['idle_share']:.3f}")
    for fam, (sec, n) in sorted(out["families"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:30s} {sec * 1e3:10.1f} ms  {100 * sec / out['device_s']:5.1f} %  "
              f"{n} launches")
    print("top kernels:")
    top = sorted(out["kernels"].items(), key=lambda kv: -kv[1][0])[:12]
    for name, (sec, n) in top:
        print(f"  {sec * 1e3:10.1f} ms  {n:6d}x  {name[:110]}")
    print(json.dumps({"wall_s": out["wall_s"], "device_s": out["device_s"],
                      "idle_share": out["idle_share"],
                      "families_ms": {k: v[0] * 1e3 for k, v in out["families"].items()}}))


if __name__ == "__main__":
    main()
