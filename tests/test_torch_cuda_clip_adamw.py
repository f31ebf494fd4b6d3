"""The optimizer step's kernels (``csrc/clip_adamw.cu``, clip by global
norm then AdamW) on the card, at the parameter sets of the three training
configurations (the resnet34 and resnet50 VAE-UNets, the plain UNet):
five steps held to torch's path on the card (``clip_`` then torch's
foreach AdamW) bit for bit, parameters, moments and the clipped gradient,
both clip branches, a learning rate changed between steps and a parameter
without a gradient; the norm within a relative 2e-7 of the float64 norm,
within that of the Python sum beyond the Python sum's own error (its 112
to 257 float32 additions stray up to ~2e-7 at these sizes), and equal to
the numpy model's fixed-order sums; a repeat run bit for bit; two
device kernels a step and no torch op; a checkpoint taken mid-run resuming on
either path; the tensor-parallel optimizer's step, the update launch on its
own norm, equal to its plain step; refused inputs.

The torch path's norm sums in another order, so where it clips the
reference scales by the kernels' norm (the clip's formula as ``clip_``
writes it); where it keeps the gradients, the reference is ``clip_``
itself.

Marked ``cuda``; each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports neither jax nor the JAX package:

    python -m pytest tests/test_torch_cuda_clip_adamw.py -m cuda --noconftest -q
"""

import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vaeunet_tpu_torch import use_fp32_numerics
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import clip_adamw
from vaeunet_tpu_torch.parallel import tp
from vaeunet_tpu_torch.training import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW, build_model

pytestmark = pytest.mark.cuda


def _load_model():
    """``tests/clip_adamw_model.py`` by its path (a card's machine may hold
    another package named ``tests``)."""
    path = Path(__file__).with_name("clip_adamw_model.py")
    spec = importlib.util.spec_from_file_location("clip_adamw_model", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


model = _load_model()

CONFIGS = {"resnet34": dict(), "resnet50": dict(backbone="resnet50"),
           "unet": dict(model_type="basic")}
STEPS = 5
LRS = [1e-4, 1e-4, 3e-4, 3e-4, 5e-5]      # the schedule moves between steps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    use_fp32_numerics()
    return torch.device("cuda")


_SHAPES = {}


def param_set(kind: str, device, seed: int = 0):
    """Fresh parameters of the configuration's model: its shapes, layouts
    and values (the model built once, on the CPU)."""
    if kind not in _SHAPES:
        net = build_model(TrainConfig(**CONFIGS[kind]), seed=0, device="cpu")
        _SHAPES[kind] = [p.detach().clone() for p in net.parameters()]
    g = torch.Generator().manual_seed(seed)
    out = []
    for t in _SHAPES[kind]:
        p = torch.empty_like(t, device=device)
        p.copy_(t + 0.01 * torch.randn(t.shape, generator=g))
        out.append(torch.nn.Parameter(p))
    return out


def make_grads(params, step: int, scale: float, skip=()):
    """Seeded gradients in the parameters' layouts; `scale` sets the norm
    (about scale * sqrt(elements) / 100)."""
    g = torch.Generator(device=params[0].device).manual_seed(1000 + step)
    out = []
    for k, p in enumerate(params):
        if k in skip:
            out.append(None)
            continue
        t = torch.empty_like(p)
        t.copy_(torch.randn(p.shape, device=p.device, generator=g) * (scale / 100))
        out.append(t)
    return out


def optimizer(params, betas=(0.9, 0.999)):
    opt = ClippedAdamW(params, TrainConfig(learning_rate=LRS[0], weight_decay=1e-5))
    opt.adamw.param_groups[0]["betas"] = betas
    return opt


def torch_step(opt: ClippedAdamW, norm: torch.Tensor) -> torch.Tensor:
    """``clip_`` with the given norm where it clips, else ``clip_`` itself;
    then torch's AdamW -> the Python sum's norm."""
    grads = [p.grad for p in opt.params if p.grad is not None]
    own = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    if bool(own < opt.max_norm) and bool(norm < opt.max_norm):
        opt.clip_()
    else:
        keep = norm < opt.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * opt.max_norm))
    opt.adamw.step()
    return own


def set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = None if g is None else g.clone()


def assert_same_state(a: ClippedAdamW, b: ClippedAdamW, what: str):
    for k, (p, q) in enumerate(zip(a.params, b.params)):
        assert torch.equal(p, q), (what, "param", k)
        assert (p.grad is None) == (q.grad is None), (what, "grad", k)
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), (what, "grad", k)
        sa, sb = a.adamw.state[p], b.adamw.state[q]
        assert sa.keys() == sb.keys(), (what, k)
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (what, key, k)


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("scale", [0.005, 2.0], ids=["keeps", "clips"])
def test_five_steps_equal_the_torch_path(cuda, kind, scale):
    params = param_set(kind, cuda)
    ref_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ours, ref = optimizer(params), optimizer(ref_params)
    _ext.reset_launch_counts()
    elems = 0
    for step in range(STEPS):
        skip = (0, 5) if step == 1 else ()        # no gradient: skipped, its step not counted
        grads = make_grads(params, step, scale, skip)
        set_grads(params, grads)
        set_grads(ref_params, grads)
        for o in (ours, ref):
            o.param_groups[0]["lr"] = LRS[step]
        host = [g.detach().cpu().numpy().ravel(order="K") for g in grads if g is not None]
        aligned = [g.data_ptr() % 16 == 0 for g in grads if g is not None]
        norm = ours.step()
        own = torch_step(ref, norm)
        torch.cuda.synchronize()
        n, o = norm.item(), own.item()
        exact = sum(float(np.dot(h.astype(np.float64), h.astype(np.float64))) for h in host) ** 0.5
        assert abs(n - exact) <= 2e-7 * exact, (step, n, o, exact)
        assert abs(n - o) <= 2e-7 * o + abs(o - exact), (step, n, o, exact)
        blocks = clip_adamw.BLOCKS_PER_SM * torch.cuda.get_device_properties(
            cuda).multi_processor_count
        assert np.float32(n) == model.norm(host, aligned, blocks), step
        assert (n >= 1.0) == (scale > 1), n
        assert_same_state(ours, ref, f"{kind} step {step}")
        elems += sum(p.numel() for p, g in zip(params, grads) if g is not None)
    counts = _ext.launch_counts()
    assert counts["clip_adamw_norm"] == counts["clip_adamw_update"] == STEPS
    assert counts["clip_adamw_elems"] == elems
    assert float(ours.adamw.state[params[0]]["step"]) == STEPS - 1
    assert float(ours.adamw.state[params[1]]["step"]) == STEPS


def test_the_numpy_model_is_torch_on_the_card(cuda):
    """The model's arithmetic (tests/clip_adamw_model.py) equals torch's
    path on the card element for element, both clip branches, both lerp
    branches, at a ragged and a one-element tensor."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for betas in ((0.9, 0.999), (0.4, 0.99)):
        for scale in (1e-3, 1.0):
            ps = [torch.nn.Parameter(torch.randn(n, device=cuda, generator=g)) for n in (1, 1003)]
            opt = optimizer(ps, betas)
            for step in range(3):
                for p in ps:
                    p.grad = torch.randn(p.shape, device=cuda, generator=g) * scale
                before = [(p.detach().cpu().numpy(), p.grad.cpu().numpy(),
                           *(opt.adamw.state[p][k].cpu().numpy() if step
                             else np.zeros(p.numel(), np.float32)
                             for k in ("exp_avg", "exp_avg_sq")))
                          for p in ps]
                norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in ps))
                torch_step(opt, norm)
                for (p0, g0, m0, v0), p in zip(before, ps):
                    want = model.update(g0, p0, m0, v0, norm.item(), 1.0, LRS[0], 1e-5, betas,
                                        1e-8, step + 1)
                    st = opt.adamw.state[p]
                    got = (p.grad, p, st["exp_avg"], st["exp_avg_sq"])
                    for w, t in zip(want, got):
                        assert np.array_equal(w, t.detach().cpu().numpy()), (betas, scale, step)


@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.4, 0.99)])
def test_both_lerp_branches_equal_the_torch_path(cuda, betas):
    params = param_set("unet", cuda, seed=3)[:40]
    ref_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ours, ref = optimizer(params, betas), optimizer(ref_params, betas)
    for step in range(3):
        grads = make_grads(params, step, 0.5)
        set_grads(params, grads)
        set_grads(ref_params, grads)
        torch_step(ref, ours.step())
        assert_same_state(ours, ref, f"betas {betas} step {step}")


def test_a_repeat_run_is_bit_for_bit(cuda):
    runs = []
    for _ in range(2):
        params = param_set("resnet34", cuda)
        opt = optimizer(params)
        norms = []
        for step in range(3):
            set_grads(params, make_grads(params, step, 2.0))
            norms.append(opt.step())
        runs.append((params, opt, torch.stack(norms)))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][2], runs[1][2])
    assert_same_state(runs[0][1], runs[1][1], "repeat")


# a profiler session in a process that has held one before may see no
# device events on the card's machine, so the traced step runs in a fresh one
TRACED_STEP = """
import json, torch
from vaeunet_tpu_torch.training import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW, build_model
params = [torch.nn.Parameter(p.detach().clone())
          for p in build_model(TrainConfig(), device="cuda").parameters()]
opt = ClippedAdamW(params, TrainConfig())
for step in range(2):
    for p in params:
        p.grad = torch.randn_like(p)
    torch.cuda.synchronize()
    if step == 0:
        opt.step()                  # the first step makes the plan and the state
        continue
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        opt.step()
        torch.cuda.synchronize()
print(json.dumps({
    "kernels": [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA],
    "ops": sorted({e.name for e in prof.events() if e.name.startswith("aten::")})}))
"""


def test_a_traced_step_runs_the_two_kernels_and_no_torch_op(cuda):
    """A step of the resnet34 parameter set: two device kernels, the norm's
    and the update's, and no aten op but the norm's empty scalar."""
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", TRACED_STEP], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    kernels = got["kernels"]
    assert len(kernels) == 2, kernels
    assert "clip_adamw_norm_kernel" in kernels[0] and "clip_adamw_update_kernel" in kernels[1]
    assert set(got["ops"]) <= {"aten::empty", "aten::empty_strided"}, got["ops"]


@pytest.mark.parametrize("resume", ["fused", "torch"])
def test_a_checkpoint_mid_run_resumes_on_either_path(cuda, resume):
    """Two steps, the state saved and loaded into a fresh optimizer, two
    more on `resume`'s path: equal to four unbroken fused steps (the steps
    keep the gradients, so both paths agree bit for bit)."""
    params = param_set("unet", cuda)
    whole = optimizer([torch.nn.Parameter(p.detach().clone()) for p in params])
    first = optimizer(params)
    for step in range(2):
        grads = make_grads(params, step, 0.005)
        for o in (whole, first):
            set_grads(o.params, grads)
            o.step()
    buf = io.BytesIO()
    torch.save({"opt": first.state_dict(),
                "params": [p.detach().cpu() for p in params]}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    fresh = [torch.nn.Parameter(t.to(cuda).contiguous(memory_format=torch.channels_last)
                                if t.dim() == 4 else t.to(cuda)) for t in saved["params"]]
    second = optimizer(fresh)
    second.load_state_dict(saved["opt"])
    for step in range(2, 4):
        grads = make_grads(params, step, 0.005)
        set_grads(whole.params, grads)
        whole.step()
        set_grads(second.params, grads)
        if resume == "fused":
            second.step()
        else:
            second.plain_step()
    assert_same_state(whole, second, f"resumed on {resume}")
    sd_w, sd_s = whole.state_dict()["adamw"], second.state_dict()["adamw"]
    assert sd_w["param_groups"] == sd_s["param_groups"]
    for k, st in sd_w["state"].items():
        for key, t in st.items():
            assert torch.equal(t.cpu(), sd_s["state"][k][key].cpu()), (k, key)


def test_state_dict_after_fused_steps_equals_torch_s(cuda):
    params = param_set("resnet50", cuda)[:60]
    ref_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ours, ref = optimizer(params), optimizer(ref_params)
    for step in range(3):
        grads = make_grads(params, step, 0.005, skip=(2,) if step == 0 else ())
        set_grads(params, grads)
        set_grads(ref_params, grads)
        ours.step()
        ref.plain_step()
    a, b = ours.state_dict(), ref.state_dict()
    assert a["max_norm"] == b["max_norm"]
    assert a["adamw"]["param_groups"] == b["adamw"]["param_groups"]
    assert a["adamw"]["state"].keys() == b["adamw"]["state"].keys()
    for k, st in b["adamw"]["state"].items():
        assert list(a["adamw"]["state"][k]) == list(st)
        for key, t in st.items():
            mine = a["adamw"]["state"][k][key]
            assert mine.dtype == t.dtype and mine.device == t.device and mine.shape == t.shape
            assert torch.equal(mine, t), (k, key)


@pytest.mark.parametrize("scale", [0.005, 2.0], ids=["keeps", "clips"])
def test_the_sharded_step_equals_its_plain_step(cuda, monkeypatch, scale):
    """ShardedClippedAdamW's step on the card, the update launch clipping
    by its own norm (no norm launch), equals its ``clip_`` + torch's AdamW
    bit for bit over three steps, a third of the tensors sharded.  One rank:
    the collectives leave their tensors as they are."""
    monkeypatch.setattr(tp, "average_over", lambda tensors, group: None)
    monkeypatch.setattr(tp.collectives, "all_reduce_sum", lambda x, group: x)
    config = TrainConfig(learning_rate=LRS[0], weight_decay=1e-5)
    params = param_set("resnet34", cuda)
    ref_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    ours = tp.ShardedClippedAdamW(params, config, params[::3], None)
    ref = tp.ShardedClippedAdamW(ref_params, config, ref_params[::3], None)
    _ext.reset_launch_counts()
    for step in range(3):
        grads = make_grads(params, step, scale)
        set_grads(params, grads)
        set_grads(ref_params, grads)
        norm, own = ours.step(), ref.plain_step()
        torch.cuda.synchronize()
        assert torch.equal(norm, own) and (norm.item() >= 1.0) == (scale > 1), step
        assert_same_state(ours, ref, f"sharded step {step}")
    counts = _ext.launch_counts()
    assert (counts["clip_adamw_norm"], counts["clip_adamw_update"]) == (0, 3)
    assert counts["clip_adamw_elems"] == 3 * sum(p.numel() for p in params)


def test_refused_inputs_raise(cuda):
    ok = torch.nn.Parameter(torch.randn(8, 4, device=cuda))
    bf16 = torch.nn.Parameter(torch.randn(8, device=cuda, dtype=torch.bfloat16))
    bf16.grad = torch.randn_like(bf16)
    ok.grad = torch.randn_like(ok)
    with pytest.raises(TypeError, match="float32"):
        optimizer([ok, bf16]).step()
    strided = torch.nn.Parameter(torch.randn(8, 8, device=cuda)[:, ::2])
    strided.grad = torch.randn(8, 4, device=cuda)
    with pytest.raises(ValueError, match="not dense"):
        optimizer([strided]).step()
    other = torch.nn.Parameter(torch.randn(8, device="cpu"))
    other.grad = torch.randn(8)
    with pytest.raises(ValueError, match="parameters on"):
        optimizer([ok, other]).step()
    q = torch.nn.Parameter(torch.randn(8, 4, device=cuda))
    q.grad = torch.randn(4, 8, device=cuda).t()            # a gradient in another layout
    with pytest.raises(ValueError, match="gradient"):
        optimizer([q]).step()
