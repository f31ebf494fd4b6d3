"""The resnet50 VAE-UNet's benchmark configuration on the CPU: the plain
reference (``benchmark/reference/bottleneck.py``) against the port at 64^2
on one seeded weight dictionary, the configuration file against the
reference, a run of the ``vaeunet_r50-train-b32`` cell at a tiny size, and
the ``bn_torch`` counter with its two metric readers.

Bounds: the forward's logits atol 5e-4, mu and logvar 1e-4 (the port's
parity bounds against the JAX package); the fp32 step's loss to float32
rounding (1e-5 relative); the fp32 step's whole gradient, by relative L2 against the reference's in
float64, within 1.5 times the float32 reference's own gap (both read about
2 % at 64^2, batch 4).
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import flops, seeds, weights
from benchmark.harness.readings import Readings
from benchmark.harness.registry import Registry
from benchmark.reference.bottleneck import BottleneckVAEUNet
from benchmark.reference.train import follow, loss_of
from benchmark.tests.tiny import ROOT
from vaeunet_tpu_torch.models.vae_unet import build_model
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.layers import BatchNorm, Conv
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step

CELL = "vaeunet_r50-train-b32"
CFG = json.loads((ROOT / "benchmark" / "configs" / "vaeunet_r50.json").read_text())
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAIN_CELLS = [w["name"] for w in SPEC["workloads"] if "-train-" in w["name"]]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def seeded(serving: bool, seed: int = 7):
    with torch.device("meta"):
        shapes = BottleneckVAEUNet()
    return weights.make(shapes, seed, "cpu", serving=serving)


def cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def state_shapes(model: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_reference_state_dict_is_the_programs():
    reg = Registry(SPEC)
    with torch.device("meta"):
        ref = BottleneckVAEUNet()
    prog = reg.config_module("vaeunet_r50").program_serving(CFG, "cpu")
    assert prog.encoder.feature_channels == CFG["encoder_channels"] and not prog.training
    assert state_shapes(ref) == state_shapes(prog)
    names = state_shapes(ref)
    assert names["encoder.layer1.0.conv3.weight"] == (256, 64, 1, 1)
    assert names["encoder.layer2.0.downsample.0.weight"] == (512, 256, 1, 1)
    assert names["encoder.layer4.0.downsample.1.running_var"] == (2048,)
    assert names["decoder_blocks.0.conv1.0.weight"] == (512, 3104, 3, 3)


def test_forward_agrees_at_64():
    w = seeded(serving=True)
    prog = weights.load(build_model(backbone="resnet50", device="cpu"), w).eval()
    ref = weights.load(BottleneckVAEUNet(), w).eval()
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 3, 64, 64), generator=g)
    eps = torch.randn((2, 32), generator=g)
    with torch.no_grad():
        lp, mp, vp = prog(cl(x), eps=eps)
        lr, mr, vr = ref(x, eps)
    assert lp.shape == lr.shape == (2, 1, 64, 64)
    torch.testing.assert_close(lp, lr, atol=5e-4, rtol=0)
    torch.testing.assert_close(mp, mr, atol=1e-4, rtol=0)
    torch.testing.assert_close(vp, vr, atol=1e-4, rtol=0)


def test_fp32_train_step_follows_the_reference():
    """One float32 step of the program (amp off) at batch 4 against the
    reference's: ``follow``'s loss, and the whole gradient before the clip
    against the reference's in float64, as near as the reference's own in
    float32 comes.  At this size a float32 gradient is 2 % from the exact
    one in either: BN removes the near-constant part of the cotangents,
    and the 2x2 bottleneck's and the broadcast latent's BNs see few rows."""
    hp = CFG["train"]
    b = 4
    config = TrainConfig(model_type="resnet", backbone="resnet50", deep_supervision=False,
                         batch_size=b, gradient_accumulation_steps=1, patch_size=64, amp=False,
                         beta=hp["beta"], free_bits=hp["free_bits"])
    w = seeded(serving=False)
    state = create_train_state(config, seed=0, device="cpu")
    weights.load(state.model, w)
    g = torch.Generator().manual_seed(3)
    images = torch.rand((b, 64, 64, 3), generator=g)
    masks = (torch.rand((b, 64, 64, 1), generator=g) > 0.85).float()
    eps = torch.randn((b, 32), generator=g)
    aux = make_train_step(config, state.model).compute_gradients(
        state, images, masks, hp["beta"], eps=eps[None])

    first = follow(weights.load(BottleneckVAEUNet(), w), [(images, masks, eps)], hp["beta"],
                   hp["free_bits"], hp["learning_rate"], hp["weight_decay"],
                   hp["gradient_clipping"])
    assert abs(float(aux["loss"]) - first["loss"][0]) <= 1e-5 * abs(first["loss"][0])

    def reference_gradient(dtype):
        ref = weights.load(BottleneckVAEUNet().train(), w).to(dtype)
        loss_of(ref, images.to(dtype), masks.to(dtype), eps.to(dtype), hp["beta"],
                hp["free_bits"]).backward()
        return {n: p.grad for n, p in ref.named_parameters()}

    program = {n: p.grad for n, p in state.model.named_parameters()}
    ref32, exact = reference_gradient(torch.float32), reference_gradient(torch.float64)
    assert set(program) == set(exact)
    names = sorted(exact)

    def gap(grad):
        a = torch.cat([grad[n].double().reshape(-1) for n in names])
        e = torch.cat([exact[n].reshape(-1) for n in names])
        return float((a - e).norm() / e.norm())

    assert gap(program) <= 1.5 * gap(ref32), (gap(program), gap(ref32))


def test_configuration_widths_are_the_references():
    reg = Registry(SPEC)
    cfg, mod = reg.config("vaeunet_r50"), reg.config_module("vaeunet_r50")
    assert cfg["backbone"] == "resnet50" and cfg["bottleneck"] is True
    assert cfg["deep_supervision"] is False and mod.HAS_LATENT
    with torch.device("meta"):
        ref = mod.reference_model(cfg)
    assert ref.encoder.channels == cfg["encoder_channels"]
    assert [len(getattr(ref.encoder, f"layer{i}")) for i in range(1, 5)] == cfg["encoder_stages"]
    blocks = ref.decoder_blocks
    assert [b.conv1[0].weight.shape[1] for b in blocks] == cfg["decoder_in_channels"]
    assert [b.conv2[0].weight.shape[0] for b in blocks] == cfg["decoder_channels"]
    assert ref.z_initial[0].weight.shape[0] == 2048 and ref.mu_head[0].weight.shape[1] == 2048
    assert blocks[0].attention.W_g[0].weight.shape == (512, 2048, 1, 1)


def test_the_cell_has_21_fused_sites():
    """At the cell's own shape, on the meta device: 13 stride-1 bottleneck
    3x3s and the decoder's 8."""
    reg = Registry(SPEC)
    cell = reg.workload(CELL)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    assert traffic["batch"] == 32 and traffic["hw"] == 512 and traffic["kind"] == "train"
    b, hw = traffic["batch"], traffic["hw"]
    with torch.device("meta"):
        ref = reg.config_module(cell["config"]).reference_model(cfg).train()
        x, m = torch.empty((b, hw, hw, 3)), torch.empty((b, hw, hw, 1))
        eps = torch.empty((b, 32))
    sites = flops.conv3x3_sites(ref, lambda: loss_of(ref, x, m, eps, 0.001, 0.001))
    assert len(sites) == 21
    assert sorted({ci for _, ci, _, _, _ in sites}) == [64, 128, 224, 256, 512, 544, 1056, 3104]
    assert all(n == b for n, *_ in sites)


CELL_RUN = r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests.tiny import tiny_registry
reg = tiny_registry(TMP, fp32_training=True)
path = reg.root / "traffic" / "train-b32.json"
path.write_text(json.dumps({**json.loads(path.read_text()), "hw": 128, "batch": 4, "pool": 16,
                            "trace_steps": 1, "enqueue_steps": 1}))
rc = run.main(["--workload", CELL, "--seed", str(2**31 + 29), "--seconds", "1", "--trace", "0"],
              device="cpu", registry=reg)
print(json.dumps({"rc": rc}))
"""


def test_the_cell_runs_correct_on_the_cpu(tmp_path):
    """The cell's files in a copy of the benchmark, its traffic shrunk to
    128^2, batch 4, the step in float32 (at a tiny size the bf16 batch
    statistics of the bottleneck are rounding noise; at 64^2 the float32
    gradient's 2 % drifts the third step's loss by 2-3e-3, at 128^2 by
    3e-4).  In a process of its own: a run refuses to start where JAX is
    loaded, as it is here."""
    head = f"ROOT = {str(ROOT)!r}\nTMP = {str(tmp_path)!r}\nCELL = {CELL!r}\n"
    out = subprocess.run([sys.executable, "-c", head + CELL_RUN], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    assert lines and json.loads(lines[-1]) == {"rc": 0}, out.stderr[-3000:]
    result = json.loads(lines[-2])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
    assert set(result["checks"]) == {"loss_gap", "grad_median_gap", "change_gap"}


# ----- the bn_torch counter -------------------------------------------------

MODELS = {
    "resnet50": (dict(backbone="resnet50"), 57),
    "resnet34": (dict(backbone="resnet34"), 24),
    "unet": (dict(model_type="basic"), 12),
}


@pytest.mark.parametrize("kind", list(MODELS))
def test_bn_torch_counts_the_training_bns_outside_fused_sites(kind):
    """Inside a profiler session, one count (and the input's bytes) for
    every training-mode BN the step runs on torch's ops: every BN of the
    model but those after a 3x3 conv of the fused kernel's shape.  Outside
    a session, nothing."""
    fields, expected = MODELS[kind]
    config = TrainConfig(batch_size=2, gradient_accumulation_steps=1, patch_size=64, amp=False,
                         **fields)
    state = create_train_state(config, seed=0, device="cpu")
    model = state.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    fused = [m for m in model.modules() if isinstance(m, Conv) and m.takes_bn_stats_kernel()]
    assert len(bns) - len(fused) == expected
    seen = []
    hooks = [bn.register_forward_pre_hook(lambda _m, args: seen.append(args[0])) for bn in bns]
    g = torch.Generator().manual_seed(4)
    images = torch.rand((2, 64, 64, 3), generator=g)
    masks = (torch.rand((2, 64, 64, 1), generator=g) > 0.9).float()
    step = make_train_step(config, model)
    try:
        _ext.reset_launch_counts()
        step.compute_gradients(state, images, masks, 0.001)
        assert _ext.LAUNCHES["bn_torch"] == 0 and _ext.LAUNCHES["bn_torch_bytes"] == 0
        seen.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            step.compute_gradients(state, images, masks, 0.001)
    finally:
        for h in hooks:
            h.remove()
    counts = _ext.launch_counts()
    assert counts["bn_torch"] == len(seen) == expected
    assert counts["bn_torch_bytes"] == sum(t.numel() * t.element_size() for t in seen)


class _Tracer:
    def __init__(self, seconds):
        self.seconds = seconds

    def seconds_by_name(self):
        return self.seconds


def test_bn_torch_readers():
    """Per step: the counter over the traced steps.  Roofline: 5 passes of
    the counted bytes at 3.35 TB/s over torch's batch-norm kernels' time,
    not the port's ``bn_train_`` or ``bn_relu_`` kernels'.  Neither reads
    without the counter (the parent) or outside a training cell."""
    reg = Registry(SPEC)
    per_step, roofline = (next(m for m in SPEC["per_layer"] if m["name"] == n)
                          for n in ("bn_torch_per_step.train", "bn_torch_roofline"))
    seconds = {"void at::native::batch_norm_collect_statistics_channels_last_kernel<...>": 0.002,
               "void at::native::batch_norm_backward_elemt_channels_last_kernel<...>": 0.003,
               "bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1, true>": 0.001,
               "void (anonymous namespace)::bn_train_fwd_kernel<__nv_bfloat16, 8, true>": 1.0,
               "void (anonymous namespace)::bn_train_bwd_apply_kernel<...>": 1.0,
               "void (anonymous namespace)::bn_relu_kernel<float, 4>": 1.0}
    r = Readings(kind="train", precision="bf16", tracer=_Tracer(seconds), traced_items=10,
                 counters={"bn_torch": 570, "bn_torch_bytes": 4_000_000_000})
    assert reg.read(per_step, r) == 57
    assert reg.read(roofline, r) == pytest.approx(100 * 5 * 4e9 / 3.35e12 / 0.006)
    r.counters = {"bn_train_fwd": 210}
    assert reg.read(per_step, r) is None and reg.read(roofline, r) is None
    r.counters = {"bn_torch": 0, "bn_torch_bytes": 0}
    assert reg.read(per_step, r) == 0 and reg.read(roofline, r) is None
    r.counters = {"bn_torch": 570, "bn_torch_bytes": 4_000_000_000}
    r.tracer = _Tracer({"void (anonymous namespace)::bn_train_fwd_kernel<float, 4, true>": 1.0})
    assert reg.read(roofline, r) is None
    r.kind = "uq"
    assert reg.read(per_step, r) is None and reg.read(roofline, r) is None
    # the training cells of their time; cells added since read nothing there
    # (no training BN runs on torch's ops) and are not listed
    for m in (per_step, roofline):
        assert m["workloads"] == TRAIN_CELLS[:3] and m["moves"] == "train_img_per_s"


def test_bn_batch_roofline_reads_the_bytes_over_the_bn_batch_kernels():
    """5 passes of the BNs' counted input bytes at 3.35 TB/s over the
    device time of the ``bn_batch_`` kernels alone (not torch's batch-norm
    kernels, not ``bn_train_`` or ``bn_relu_``); nothing without a
    ``bn_batch_fwd`` count (the parent), without those kernels' time or
    outside a training cell; its entry moves the training rate in the
    three training cells."""
    reg = Registry(SPEC)
    entry = next(m for m in SPEC["per_layer"] if m["name"] == "bn_batch_roofline")
    seconds = {"void (anonymous namespace)::bn_batch_moments_kernel<__nv_bfloat16, 8>": 0.001,
               "void (anonymous namespace)::bn_batch_fwd_kernel<__nv_bfloat16, 8, true>": 0.002,
               "void (anonymous namespace)::bn_batch_bwd_reduce_kernel<...>": 0.002,
               "void (anonymous namespace)::bn_batch_bwd_apply_kernel<...>": 0.003,
               "void (anonymous namespace)::bn_train_fwd_kernel<__nv_bfloat16, 8, true>": 1.0,
               "void at::native::batch_norm_collect_statistics_channels_last_kernel<...>": 1.0,
               "void (anonymous namespace)::bn_relu_kernel<float, 4>": 1.0}
    r = Readings(kind="train", precision="bf16", tracer=_Tracer(seconds), traced_items=10,
                 counters={"bn_batch_fwd": 570, "bn_batch_bwd": 570,
                           "bn_batch_bytes": 4_000_000_000, "bn_torch": 0})
    assert reg.read(entry, r) == pytest.approx(100 * 5 * 4e9 / 3.35e12 / 0.008)
    for counters in ({}, {"bn_torch": 570, "bn_torch_bytes": 4_000_000_000},
                     {"bn_batch_fwd": 0, "bn_batch_bytes": 0}):
        r.counters = counters
        assert reg.read(entry, r) is None
    r.counters = {"bn_batch_fwd": 570, "bn_batch_bytes": 4_000_000_000}
    r.tracer = _Tracer({k: v for k, v in seconds.items() if "bn_batch_" not in k})
    assert reg.read(entry, r) is None
    r.tracer = _Tracer(seconds)
    r.kind = "uq"
    assert reg.read(entry, r) is None
    assert entry["workloads"] == TRAIN_CELLS and entry["moves"] == "train_img_per_s"
    assert entry["layer"] == "kernels" and entry["source"] == "device_trace"
