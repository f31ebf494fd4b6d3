"""The optimizer step's kernels (``csrc/clip_adamw.cu``) on the CPU: the
numpy model of the update kernel's arithmetic (``tests/clip_adamw_model.py``)
against ``clip_`` + ``torch.optim.AdamW`` for five steps; the norm kernel's
fixed-order sums against the Python sum; the tensor table and the C
entries' arguments with a fake library that runs the model on the table's
pointers; which path a step takes, and the tensor-parallel optimizer's
step on its own norm; the state after fused steps; the source's constants;
the ``adamw_roofline`` reader.

The model equals torch's path on the card bit for bit
(``tests/test_torch_cuda_clip_adamw.py``).  Torch's CPU kernels round
three steps otherwise: their float32 sqrt is an ulp off on some inputs,
addcmul takes fma(g, c2 g, v) where the card takes fma(c2, g g, v), and
addcdiv divides (value m) / d where the card multiplies value (m / d).  So
here the clipped gradient and ``exp_avg`` (lerp is one fma on both) are
held bit for bit, and ``exp_avg_sq`` and the parameters, each step from
torch's state before it, within the ulps those three roundings give.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import clip_adamw_model as model
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import clip_adamw
from vaeunet_tpu_torch.parallel import tp
from vaeunet_tpu_torch.parallel.tp import ShardedClippedAdamW
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "vaeunet_tpu_torch" / "csrc" / "clip_adamw.cu").read_text()
SIZES = [1, 7, 64, 1003, 4096, 16385, 40001]      # ragged (not a multiple of 4), one element
LRS = [1e-3, 1e-3, 3e-3, 3e-3, 5e-4]              # changed between steps
CONFIG = TrainConfig(learning_rate=LRS[0], weight_decay=1e-2)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 ulps between two same-signed arrays."""
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if a.size else 0


def ulps_of(a: np.ndarray, b: np.ndarray, size: np.ndarray) -> float:
    """The largest |a - b| in float32 ulps of `size`."""
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(size).astype(np.float32)))
                 .max()) if a.size else 0.0


def params_of(sizes, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(n, generator=g)) for n in sizes]


def grads_of(params, step: int, scale: float, skip=()):
    g = torch.Generator().manual_seed(100 + step)
    return [None if k in skip else torch.randn(p.shape, generator=g) * scale
            for k, p in enumerate(params)]


def set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = None if g is None else g.clone()


def snapshot(opt, p):
    st = opt.adamw.state[p]
    if not st:
        return np.zeros(p.numel(), np.float32), np.zeros(p.numel(), np.float32), 0.0
    return st["exp_avg"].numpy().copy(), st["exp_avg_sq"].numpy().copy(), float(st["step"])


@pytest.mark.parametrize("scale", [1e-3, 1.0], ids=["keeps", "clips"])
def test_update_model_against_clip_and_adamw_for_five_steps(scale):
    params = params_of(SIZES)
    opt = ClippedAdamW(params, CONFIG)
    worst = {"v": 0, "p": 0}
    for step in range(5):
        skip = (2,) if step in (1, 2) else ()          # no gradient: skipped
        set_grads(params, grads_of(params, step, scale, skip))
        opt.param_groups[0]["lr"] = LRS[step]
        before = {id(p): (p.detach().numpy().copy(), p.grad.numpy().copy(), *snapshot(opt, p))
                  for p in params if p.grad is not None}
        norm = opt.plain_step()
        assert (float(norm) >= 1.0) == (scale == 1.0)
        for p in params:
            if id(p) not in before:
                continue
            p0, g0, m0, v0, s0 = before[id(p)]
            g, pn, m, v = model.update(g0, p0, m0, v0, float(norm), opt.max_norm, LRS[step],
                                       CONFIG.weight_decay, (0.9, 0.999), 1e-8, s0 + 1)
            st = opt.adamw.state[p]
            assert np.array_equal(g, p.grad.numpy()), step
            assert np.array_equal(m, st["exp_avg"].numpy()), step
            worst["v"] = max(worst["v"], ulps(v, st["exp_avg_sq"].numpy()))
            step_size = clip_adamw.bias_corrections(0.9, 0.999, LRS[step], s0 + 1)[0]
            d = np.sqrt(v.astype(np.float64)) / (1 - 0.999 ** (s0 + 1)) ** 0.5 + 1e-8
            size = np.abs(pn.astype(np.float64)) + np.abs(step_size * m / d)
            worst["p"] = max(worst["p"], ulps_of(pn, p.detach().numpy(), size))
    # v: fma(g, c2 g, v) against fma(c2, g g, v), each product rounded
    # otherwise: two ulps.  p: sqrt's ulp and the other addcdiv order move
    # the update by an ulp or two, the sum by half an ulp more: three ulps of
    # |p| + |update|
    assert worst["v"] <= 2 and worst["p"] <= 3, worst


@pytest.mark.parametrize("sizes,aligned,blocks", [
    (SIZES, True, 528),
    (SIZES, False, 3),
    ([5] * 500 + [70000], True, 7),                  # a table of 501 tensors
    ([0, 3, 0, 16384, 0], True, 2),                  # tensors of no elements
])
def test_norm_model_against_the_python_sum(sizes, aligned, blocks):
    """The norm kernel's fixed-order partial sums against ``clip_``'s
    (torch's sum a tensor, added in Python), within a relative 2e-7."""
    params = params_of(sizes, seed=1)
    grads = grads_of(params, 0, 0.3)
    ours = model.norm([g.numpy() for g in grads], [aligned] * len(grads), blocks)
    theirs = float(torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads)))
    assert abs(float(ours) - theirs) <= 2e-7 * theirs


def test_chunk_map_and_grid():
    c0 = model.chunk_map([1, 16384, 16385, 0, 40000])
    assert c0.tolist() == [0, 1, 2, 4, 4, 7]
    assert model.grid(0, 528) == 1 and model.grid(3, 528) == 3
    assert model.grid(5000, 528) == 528


# ----- the tensor table and the C entries, with a fake library ------------

def _floats(ptr: int, n: int) -> np.ndarray:
    if not n:
        return np.zeros(0, np.float32)
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


class _FakeKernels:
    """The two C entries on CPU memory: the numpy model run on what the
    table's pointers address, the scalars rounded as ctypes rounds them."""

    def __init__(self):
        self.calls = []

    def vaeunet_clip_adamw_norm(self, table, count, partial, ticket, norm, blocks, stream):
        self.calls.append(("norm", (table, count, partial, ticket, norm, blocks, stream)))
        t = np.ctypeslib.as_array((ctypes.c_int64 * (5 * count)).from_address(table))
        t = t.reshape(5, count)
        assert int(np.ctypeslib.as_array((ctypes.c_int32 * 1).from_address(ticket))[0]) == 0
        grads = [_floats(int(t[0, k]), int(t[4, k])) for k in range(count)]
        _floats(norm, 1)[0] = model.norm(grads, [int(t[0, k]) % 16 == 0 for k in range(count)],
                                         blocks)
        return 0

    def vaeunet_clip_adamw_update(self, table, scalars, count, norm, decay, w1, beta2, c2, eps,
                                  max_norm, blocks, stream):
        args = (decay, w1, beta2, c2, eps, max_norm)
        self.calls.append(("update", (table, scalars, count, norm, *args, blocks, stream)))
        t = np.ctypeslib.as_array((ctypes.c_int64 * (5 * count)).from_address(table))
        t = t.reshape(5, count)
        sc = _floats(scalars, 2 * count).reshape(2, count)
        nv = _floats(norm, 1)[0]
        for k in range(count):
            n = int(t[4, k])
            g, p, m, v = (_floats(int(t[r, k]), n) for r in range(4))
            g1, p1, m1, v1 = model.update_kernel(g, p, m, v, nv, *args, sc[0, k], sc[1, k])
            if not nv < np.float32(max_norm):
                g[:] = g1
            p[:], m[:], v[:] = p1, m1, v1
        return 0


@pytest.fixture
def fake(monkeypatch):
    kernels = _FakeKernels()
    monkeypatch.setattr(_ext, "_FNS", {})
    monkeypatch.setattr(_ext, "library", lambda name: kernels)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 77)
    monkeypatch.setattr(clip_adamw, "_sms", lambda device: 3)
    return kernels


def fused_step(opt: ClippedAdamW) -> torch.Tensor:
    """ClippedAdamW.step's CUDA branch, on CPU tensors."""
    return opt.kernel_step()


def test_table_and_arguments_with_a_fake_library(fake):
    """The table's rows (g, p, exp_avg, exp_avg_sq, numel) address the
    tensors; a parameter without a gradient leaves it and its step count;
    the scalars are torch's bias corrections at each tensor's own step; the
    launches equal the model computed from the tensors themselves."""
    params = params_of(SIZES)
    opt = ClippedAdamW(params, CONFIG)
    _ext.reset_launch_counts()
    elems = 0
    for step in range(4):
        skip = (1,) if step == 1 else ()
        set_grads(params, grads_of(params, step, 1.0, skip))
        opt.param_groups[0]["lr"] = LRS[step]
        live = [p for p in params if p.grad is not None]
        before = {id(p): (p.detach().numpy().copy(), p.grad.numpy().copy(), *snapshot(opt, p))
                  for p in live}
        want_norm = model.norm([p.grad.numpy() for p in live],
                               [p.grad.data_ptr() % 16 == 0 for p in live], 4 * 3)
        norm = fused_step(opt)
        assert float(norm) == float(want_norm)
        (kind, nargs), (kind2, uargs) = fake.calls[-2:]
        assert (kind, kind2) == ("norm", "update")
        plan = opt._kernel_box[0].plan
        n = len(live)
        assert nargs[1] == n and nargs[5] == 4 * 3 and nargs[6] == 77
        assert nargs[4] == norm.data_ptr() and nargs[2] == plan.partial.data_ptr()
        assert plan.partial.numel() == 4 * 3
        rows = np.ctypeslib.as_array((ctypes.c_int64 * (5 * n)).from_address(nargs[0]))
        rows = rows.reshape(5, n)
        for k, p in enumerate(live):
            st = opt.adamw.state[p]
            assert rows[:, k].tolist() == [p.grad.data_ptr(), p.data_ptr(),
                                           st["exp_avg"].data_ptr(), st["exp_avg_sq"].data_ptr(),
                                           p.numel()]
        assert uargs[2] == n and uargs[3] == norm.data_ptr() and uargs[-2:] == (12, 77)
        lr = LRS[step]
        assert uargs[4:10] == (1 - lr * CONFIG.weight_decay, 1 - 0.9, 0.999, 1 - 0.999, 1e-8,
                               1.0)
        sc = _floats(uargs[1], 2 * n).reshape(2, n)
        for k, p in enumerate(live):
            s0 = before[id(p)][4]
            assert float(opt.adamw.state[p]["step"]) == s0 + 1
            ss, bc2 = clip_adamw.bias_corrections(0.9, 0.999, lr, s0 + 1)
            assert (sc[0, k], sc[1, k]) == (np.float32(ss), np.float32(bc2))
            p0, g0, m0, v0, _ = before[id(p)]
            g, pn, m, v = model.update(g0, p0, m0, v0, want_norm, 1.0, lr, CONFIG.weight_decay,
                                       (0.9, 0.999), 1e-8, s0 + 1)
            st = opt.adamw.state[p]
            for w, got in ((g, p.grad), (pn, p.detach()), (m, st["exp_avg"]),
                           (v, st["exp_avg_sq"])):
                assert np.array_equal(w, got.numpy()), (step, k)
        elems += sum(p.numel() for p in live)
    counts = _ext.launch_counts()
    assert (counts["clip_adamw_norm"], counts["clip_adamw_update"]) == (4, 4)
    assert counts["clip_adamw_elems"] == elems
    assert float(opt.adamw.state[params[1]]["step"]) == 3
    assert float(opt.adamw.state[params[0]]["step"]) == 4


def test_a_plan_lasts_until_something_it_holds_changes(fake):
    params = params_of(SIZES[:3])
    opt = ClippedAdamW(params, CONFIG)
    set_grads(params, grads_of(params, 0, 1.0))
    fused_step(opt)
    kept = opt._kernel_box[0]
    set_grads(params, grads_of(params, 1, 1.0))
    fused_step(opt)
    assert opt._kernel_box[0] is kept                      # new gradients, the same plan
    steps = [opt.adamw.state[p]["step"] for p in params]
    assert [float(t) for t in steps] == [2, 2, 2]          # torch's own step tensors, counted
    assert len({t.data_ptr() for t in steps}) == 3
    opt.load_state_dict(opt.state_dict())
    assert opt._kernel_box[0] is None                      # a load forgets it
    set_grads(params, grads_of(params, 2, 1.0))
    fused_step(opt)
    kept = opt._kernel_box[0]
    opt.plain_step()                                       # torch's step forgets it
    assert opt._kernel_box[0] is None
    set_grads(params, grads_of(params, 3, 1.0, skip=(0,)))
    fused_step(opt)
    assert opt._kernel_box[0] is not kept and opt._kernel_box[0].active == [1, 2]
    assert [float(opt.adamw.state[p]["step"]) for p in params] == [4, 5, 5]


def test_cpu_parameters_take_the_plain_path(fake):
    params = params_of(SIZES[:3])
    opt = ClippedAdamW(params, CONFIG)
    set_grads(params, grads_of(params, 0, 1.0))
    _ext.reset_launch_counts()
    opt.step()
    assert fake.calls == [] and _ext.launch_counts()["clip_adamw_norm"] == 0
    assert float(opt.adamw.state[params[0]]["step"]) == 1


class _OnCuda:
    """A stand-in for a CUDA parameter where ``step`` reads the device."""
    device = torch.device("cuda", 0)


def test_cuda_parameters_take_the_kernels(monkeypatch):
    seen = []
    monkeypatch.setattr(ClippedAdamW, "kernel_step", lambda self: seen.append(self) or "norm")
    params = params_of(SIZES[:2])
    set_grads(params, grads_of(params, 0, 1.0))
    for opt in (ClippedAdamW(params, CONFIG), ShardedClippedAdamW(params, CONFIG, [], None)):
        opt.params = [_OnCuda(), *params]
        assert opt.step() == "norm" and seen == [opt]
        seen.clear()


def test_the_sharded_optimizer_clips_by_its_own_norm(fake, monkeypatch):
    """ShardedClippedAdamW's kernel step: its norm (the replicated
    gradients averaged, the sharded ones' squares summed over the group)
    and the update launch, no norm launch; equal to its ``clip_`` and
    torch's AdamW.  One rank: the collectives leave their tensors as they
    are."""
    monkeypatch.setattr(tp, "average_over", lambda tensors, group: None)
    monkeypatch.setattr(tp.collectives, "all_reduce_sum", lambda x, group: x)
    a, b = params_of(SIZES[:4]), params_of(SIZES[:4])
    ours = ShardedClippedAdamW(a, CONFIG, a[1:3], group=None)
    ref = ShardedClippedAdamW(b, CONFIG, b[1:3], group=None)
    for step in range(2):
        grads = grads_of(a, step, 1.0)
        set_grads(a, grads)
        set_grads(b, grads)
        fake.calls.clear()
        norm = fused_step(ours)
        assert [kind for kind, _ in fake.calls] == ["update"]
        assert fake.calls[0][1][3] == norm.data_ptr()
        assert torch.equal(norm, ref.plain_step())
        for p, q in zip(a, b):
            assert torch.equal(p.grad, q.grad)
            st, sr = ours.adamw.state[p], ref.adamw.state[q]
            assert float(st["step"]) == float(sr["step"]) == step + 1
            assert torch.equal(st["exp_avg"], sr["exp_avg"])
            assert ulps(st["exp_avg_sq"].numpy(), sr["exp_avg_sq"].numpy()) <= 2


def test_inputs_the_kernels_cannot_take_raise(fake):
    half = torch.nn.Parameter(torch.randn(8, dtype=torch.bfloat16))
    half.grad = torch.randn(8, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fused_step(ClippedAdamW([half], CONFIG))
    strided = torch.nn.Parameter(torch.randn(8, 8)[:, ::2])
    strided.grad = torch.randn(8, 4)
    with pytest.raises(ValueError, match="not dense"):
        fused_step(ClippedAdamW([strided], CONFIG))
    p = torch.nn.Parameter(torch.randn(8, 4))
    p.grad = torch.randn(4, 8).t()                         # a gradient in another layout
    with pytest.raises(ValueError, match="gradient"):
        fused_step(ClippedAdamW([p], CONFIG))
    q = torch.nn.Parameter(torch.randn(8, 4))
    p.grad, q.grad = torch.randn(8, 4), torch.randn(8, 4)
    opt = ClippedAdamW([p, q], CONFIG)
    moments = [torch.zeros_like(p), torch.zeros_like(q)]
    plan = clip_adamw.Plan([p, q], moments, moments)
    plan.device = torch.device("meta")                     # the gradients' device differs
    with pytest.raises(ValueError, match="gradient"):
        plan.set_grads([p.grad, q.grad])
    moments[1] = torch.zeros(4, 8).t()                     # a moment in another layout
    with pytest.raises(ValueError, match="exp_avg"):
        clip_adamw.Plan([p, q], moments, moments)
    many = params_of([2] * (clip_adamw.MAX_TENSORS + 1))
    set_grads(many, grads_of(many, 0, 1.0))
    with pytest.raises(ValueError, match="at most 512"):
        fused_step(ClippedAdamW(many, CONFIG))
    p.grad = q.grad = None
    with pytest.raises(ValueError, match="no parameter"):
        fused_step(opt)
    p.grad, q.grad = torch.randn(8, 4), torch.randn(8, 4)
    opt.param_groups[0]["amsgrad"] = True                  # not in the kernels: nothing counted
    with pytest.raises(ValueError, match="amsgrad"):
        fused_step(opt)
    assert len(opt.adamw.state[p]) == 0
    assert fake.calls == []


def test_the_state_after_fused_steps_is_torch_s_and_resumes_on_either_path(fake):
    """Fused steps leave AdamW's state as torch's steps leave it: the same
    keys in the same order, dtypes, devices and step counts, ``exp_avg`` bit
    for bit (lerp rounds alike here), ``exp_avg_sq`` within an ulp; a state
    saved after fused steps resumes on torch's path and the other way."""
    a, b = params_of(SIZES), params_of(SIZES)
    fused, plain = ClippedAdamW(a, CONFIG), ClippedAdamW(b, CONFIG)
    for step in range(3):
        grads = grads_of(a, step, 1e-3, skip=(3,) if step == 0 else ())
        set_grads(a, grads)
        set_grads(b, grads)
        fused_step(fused)
        plain.plain_step()
    sa, sb = fused.state_dict(), plain.state_dict()
    assert sa["max_norm"] == sb["max_norm"]
    assert sa["adamw"]["param_groups"] == sb["adamw"]["param_groups"]
    assert list(sa["adamw"]["state"]) == list(sb["adamw"]["state"])
    for k, st in sb["adamw"]["state"].items():
        mine = sa["adamw"]["state"][k]
        assert list(mine) == list(st)
        for key, t in st.items():
            assert (mine[key].dtype, mine[key].device, mine[key].shape) == (t.dtype, t.device,
                                                                           t.shape)
        assert torch.equal(mine["step"], st["step"]) and torch.equal(mine["exp_avg"],
                                                                     st["exp_avg"])
        assert ulps(mine["exp_avg_sq"].numpy(), st["exp_avg_sq"].numpy()) <= 2
    # resume: the fused state on torch's path, torch's on the kernels
    swapped_a, swapped_b = ClippedAdamW(a, CONFIG), ClippedAdamW(b, CONFIG)
    swapped_a.load_state_dict(sa)
    swapped_b.load_state_dict(sb)
    grads = grads_of(a, 3, 1e-3)
    set_grads(a, grads)
    set_grads(b, grads)
    swapped_a.plain_step()
    fused_step(swapped_b)
    for p in a + b:
        opt = swapped_a if any(p is q for q in a) else swapped_b
        assert float(opt.adamw.state[p]["step"]) == (3 if p is a[3] or p is b[3] else 4)
    assert all(bool(torch.isfinite(p).all()) for p in a + b)


def test_source_constants_and_kernel_names():
    """The source's block, chunk and table size are the wrapper's; both
    tables fit a launch's 32,764 bytes of parameters; the kernels' names
    start ``clip_adamw_`` and hold none of the names other families read."""
    for name, value in (("kThreads", clip_adamw.THREADS), ("kChunk", clip_adamw.CHUNK),
                        ("kMaxTensors", clip_adamw.MAX_TENSORS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1]) == value, name
    n = clip_adamw.MAX_TENSORS
    norm_table = 8 * n + 8 * n + 4 * (n + 1) + 4
    update_table = 4 * 8 * n + 8 * n + 4 * (n + 1) + 4 * n + 4 * n + 4
    assert f"{norm_table:,} bytes" in SOURCE and f"{update_table:,} bytes" in SOURCE
    assert update_table + 8 + 6 * 4 <= 32764 and norm_table + 4 * 8 + 2 * 4 <= 32764
    names = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n(\w+)\(", SOURCE)
    assert names == ["clip_adamw_norm_kernel", "clip_adamw_update_kernel"]
    for name in names:
        for taken in ("bn_", "conv", "copy", "fill", "cat_", "gemm", "batch_norm",
                      "multi_tensor_apply", "resize", "normal_kernel", "reparam"):
            assert taken not in name, (name, taken)
    assert set(_ext.SIGNATURES["clip_adamw"]) == {clip_adamw.NORM_FN, clip_adamw.UPDATE_FN}


# ----- the benchmark's reader ----------------------------------------------

def load_reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Tracer:
    def __init__(self, seconds):
        self.seconds = seconds

    def seconds_by_name(self):
        return self.seconds


def test_adamw_roofline_reads_32_bytes_an_element_over_the_kernels_time():
    from benchmark.harness.readings import Readings
    reader = load_reader("adamw_roofline")
    seconds = {"(anonymous namespace)::clip_adamw_norm_kernel(NormTable, float*, ...)": 0.0002,
               "(anonymous namespace)::clip_adamw_update_kernel(UpdateTable, ...)": 0.0008,
               "void at::native::multi_tensor_apply_kernel<...>": 1.0,
               "void (anonymous namespace)::bn_train_fwd_kernel<...>": 1.0}
    counters = {"clip_adamw_norm": 2, "clip_adamw_update": 2, "clip_adamw_elems": 2 * 30_000_000}
    r = Readings(kind="train", precision="bf16", tracer=_Tracer(seconds), traced_items=2,
                 counters=dict(counters))
    assert reader.read(r) == pytest.approx(100 * 32 * 60e6 / 3.35e12 / 0.001)
    for bad in ({}, {"clip_adamw_norm": 2, "clip_adamw_update": 1, "clip_adamw_elems": 9},
                {"clip_adamw_norm": 4, "clip_adamw_update": 4, "clip_adamw_elems": 9},
                {"clip_adamw_norm": 2, "clip_adamw_update": 2, "clip_adamw_elems": 0}):
        r.counters = bad
        assert reader.read(r) is None, bad
    r.counters = dict(counters)
    r.tracer = _Tracer({"void at::native::multi_tensor_apply_kernel<...>": 1.0})
    assert reader.read(r) is None
    r.tracer, r.kind = _Tracer(seconds), "uq"
    assert reader.read(r) is None
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "adamw_roofline")
    assert entry["layer"] == "kernels"
    assert entry["moves"] == "train_img_per_s" and entry["unit"] == "%"
    assert set(entry["workloads"]) == {w["name"] for w in spec["workloads"]
                                       if "-train-" in w["name"]}
