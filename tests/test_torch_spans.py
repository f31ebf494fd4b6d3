"""The port's spans and counters (``utils/profiling.py``'s recorder, the
``train.*`` and ``serve.*`` spans, ``ops/_ext.py``'s counters) and the
benchmark's readers of them (``benchmark/harness/program_spans.py``,
``benchmark/metrics/``), on the CPU.  Spans are recorded only inside a
``torch.profiler`` session; here it traces the CPU alone."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import program_spans
from benchmark.harness.readings import Readings
from benchmark.harness.registry import Registry
from benchmark.harness.trace import Tracer, union_intervals
from vaeunet_tpu_torch.inference import segmentation_distribution, uncertainty_maps
from vaeunet_tpu_torch.inference.tiled import predict_with_patches
from vaeunet_tpu_torch.models.vae_unet import build_model
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from vaeunet_tpu_torch.utils import profiling

SPEC = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
MS = 1_000_000                                     # ns


@pytest.fixture(autouse=True)
def _fresh():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(prev)


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def names(spans):
    return [s.name for s in spans]


def assert_sequential(children, parent):
    """`children` lie inside `parent`, one after another."""
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    assert parent.start_ns <= children[0].start_ns and children[-1].end_ns <= parent.end_ns


# ----- the recorder ---------------------------------------------------------


def test_nothing_is_recorded_outside_a_profiler_session():
    assert profiling.span("a") is profiling.span("b")     # the shared no-op
    for _ in range(3):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert profiling.spans() == []
    with traced():
        with profiling.span("inside"):
            pass
    with profiling.span("after"):
        pass
    assert names(profiling.spans()) == ["inside"]


def test_spans_nest_with_parent_and_root():
    with traced():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            pass
    a, b, c, d, e = profiling.spans()
    assert names([a, b, c, d, e]) == ["a", "b", "c", "d", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (-1, a.index, b.index,
                                                                  a.index, -1)
    assert {a.root, b.root, c.root, d.root} == {a.index} and e.root == e.index != a.index
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns


def test_the_span_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", profiling.collections.deque(maxlen=4))
    with traced():
        for k in range(6):
            with profiling.span(f"s{k}"):
                pass
    assert names(profiling.spans()) == ["s2", "s3", "s4", "s5"]


def test_ext_call_counts_only_while_recording(monkeypatch):
    calls = []
    monkeypatch.setitem(_ext._FNS, "vaeunet_test_fn", lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(_ext, "_current_device", lambda: 0)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 1234)
    dev = torch.device("cuda", 0)
    _ext.reset_launch_counts()
    _ext.call("none", "vaeunet_test_fn", dev, 7)
    assert _ext.launch_counts()["ext_calls"] == 0 == _ext.launch_counts()["ext_call_ns"]
    with traced():
        _ext.call("none", "vaeunet_test_fn", dev, 8)
        _ext.call("none", "vaeunet_test_fn", dev, 9)
    _ext.call("none", "vaeunet_test_fn", dev, 10)
    counts = _ext.launch_counts()
    assert counts["ext_calls"] == 2 and counts["ext_call_ns"] > 0
    assert calls == [(7, 1234), (8, 1234), (9, 1234), (10, 1234)]
    _ext.reset_launch_counts()


def test_ext_call_counts_a_failing_call(monkeypatch):
    monkeypatch.setitem(_ext._FNS, "vaeunet_test_fail", lambda *a: 700)
    monkeypatch.setattr(_ext, "_current_device", lambda: 0)
    monkeypatch.setattr(_ext, "_raw_stream", lambda: 0)
    _ext.reset_launch_counts()
    with traced(), pytest.raises(RuntimeError, match="CUDA error 700"):
        _ext.call("none", "vaeunet_test_fail", torch.device("cuda", 0))
    assert _ext.launch_counts()["ext_calls"] == 1
    _ext.reset_launch_counts()


# ----- the program's spans ----------------------------------------------------


def test_indexed_train_step_records_its_phases_in_order():
    config = TrainConfig(model_type="resnet", batch_size=2, gradient_accumulation_steps=1,
                         patch_size=32, amp=False)
    state = create_train_state(config, seed=0, device="cpu")
    step = make_train_step(config, state.model, indexed=True)
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (4, 32, 32, 3), generator=g, dtype=torch.uint8)
    masks = (torch.rand((4, 32, 32, 1), generator=g) > 0.8).to(torch.uint8)
    eps = torch.randn((1, 2, config.latent_dim), generator=g)
    step(state, images, masks, np.array([0, 3]), 0.001, eps=eps)       # untraced
    assert profiling.spans() == []
    with traced():
        step(state, images, masks, np.array([1, 2]), 0.001, eps=eps)
    root, *phases = profiling.spans()
    assert root.name == "train.step" and root.parent == -1
    assert names(phases) == ["train.gather", "train.forward", "train.backward", "train.clip",
                             "train.adamw"]
    assert all(s.parent == root.index == s.root for s in phases)
    assert_sequential(phases, root)


def test_tiled_request_records_its_stages_and_counts_tiles():
    model = build_model(seed=0, device="cpu")
    image = torch.rand((32, 80, 3), generator=torch.Generator().manual_seed(1))
    eps = torch.randn((2, 1, 32), generator=torch.Generator().manual_seed(2))
    _ext.reset_launch_counts()
    with traced():
        samples, _, _ = segmentation_distribution(model, image, num_samples=2, patch_size=32,
                                                  overlap=8, tile_batch=2, eps=eps,
                                                  device="cpu")
        uncertainty_maps(samples)
    counts = _ext.launch_counts()
    assert (counts["tiles"], counts["tile_slots"]) == (3, 4)     # 3 tiles, batches of 2
    dist, latent, tiled, *stages, maps = profiling.spans()
    assert names([dist, latent, tiled, maps]) == ["serve.distribution", "serve.latent",
                                                  "serve.tiled", "serve.maps"]
    assert names(stages) == ["serve.tiles", "serve.encode", "serve.weights", "serve.decode",
                             "serve.blend", "serve.decode", "serve.blend"]
    assert dist.parent == -1 and maps.parent == -1 and maps.root == maps.index
    assert latent.parent == tiled.parent == dist.index
    assert all(s.parent == tiled.index and s.root == dist.index for s in stages)
    assert_sequential([latent, tiled], dist)
    assert_sequential(stages, tiled)
    assert dist.end_ns <= maps.start_ns

    profiling.clear_spans()
    with traced():
        predict_with_patches(model, image, torch.zeros((1, 32)), 32, overlap=8, batch_size=3,
                             device="cpu")
    counts = _ext.launch_counts()
    assert (counts["tiles"], counts["tile_slots"]) == (6, 7)      # + 3 tiles in one batch
    assert names(profiling.spans()) == ["serve.tiled", "serve.tiles", "serve.encode",
                                        "serve.weights", "serve.decode", "serve.blend"]
    _ext.reset_launch_counts()


# ----- the readers --------------------------------------------------------------

TRAIN_SPANS = [
    (0, "train.step", 5, 95, -1, 0),
    (1, "train.gather", 5, 12, 0, 0),
    (2, "train.forward", 12, 40, 0, 0),
    (3, "train.backward", 40, 65, 0, 0),
    (4, "train.clip", 65, 80, 0, 0),
    (5, "train.adamw", 80, 90, 0, 0),
]


def readings(spans, monkeypatch, kind="train", items=1, window=(0, 100)):
    """A traced segment of `items` over `window` (ms), the device busy over
    [10, 30] and [60, 70] ms, and the program's `spans` (ms)."""
    tracer = Tracer()
    tracer.start_ns, tracer.end_ns = window[0] * MS, window[1] * MS
    tracer.events = [("k", 10 * MS, 20 * MS), ("k", 15 * MS, 30 * MS),
                     ("k", 60 * MS, 70 * MS), ("k", 110 * MS, 120 * MS)]
    monkeypatch.setattr(profiling, "spans", lambda: [
        (i, n, a * MS, b * MS, p, r) for i, n, a, b, p, r in spans])
    return Readings(kind=kind, precision="bf16", items=5, work_s=1.0, tracer=tracer,
                    traced_items=items)


def read(metric, r):
    return Registry(SPEC).read({"name": metric}, r)


def test_train_readers_by_hand(monkeypatch):
    r = readings(TRAIN_SPANS, monkeypatch)
    assert read("forward_host_ms.train", r) == pytest.approx(28)
    assert read("backward_host_ms.train", r) == pytest.approx(25)
    assert read("optimizer_host_ms.train", r) == pytest.approx(15 + 10)
    assert read("entry_host_ms.train", r) == pytest.approx(90 - 85 + 7)
    # idle: [0,10] [30,60] [70,100] = 70 ms; gather 5, forward 10, backward 20,
    # clip 10, adamw 10, step's own [90,95] 5; outside the step 10
    assert read("entry_idle_pct.train", r) == pytest.approx(100 * 30 / 70)
    assert read("entry_idle_pct.uq", r) is None


def test_serving_readers_by_hand(monkeypatch):
    spans = [
        (0, "serve.distribution", 0, 60, -1, 0),
        (1, "serve.latent", 2, 10, 0, 0),
        (2, "serve.tiled", 10, 58, 0, 0),
        (3, "serve.tiles", 10, 12, 2, 0),
        (4, "serve.encode", 12, 25, 2, 0),
        (5, "serve.weights", 25, 45, 2, 0),
        (6, "serve.decode", 45, 50, 2, 0),
        (7, "serve.blend", 50, 55, 2, 0),
        (8, "serve.maps", 62, 64, -1, 8),
    ]
    r = readings(spans, monkeypatch, kind="uq")
    # self: distribution 60-8-48 = 4, tiled 48-45 = 3, tiles 2, weights 20, blend 5, maps 2
    assert read("entry_host_ms.uq", r) == pytest.approx(4 + 3 + 2 + 20 + 5 + 2)
    # idle 70: distribution [0,2] 2, latent [2,10] 8, weights [30,45] 15, decode 5,
    # blend 5, tiled [55,58] 3, distribution [58,60] 2; maps on a busy device 0;
    # after the request 30
    assert read("entry_idle_pct.uq", r) == pytest.approx(100 * (2 + 15 + 5 + 3 + 2) / 70)
    assert read("entry_host_ms.predict", r) is None
    r.counters = {"tiles": 77, "tile_slots": 80}
    assert read("tile_use_pct.uq", r) == 96.25
    assert read("tile_use_pct.predict", r) is None
    r = readings(spans[2:8], monkeypatch, kind="predict")        # serve.tiled is the root
    r.counters = {"tiles": 15, "tile_slots": 16}
    assert read("tile_use_pct.predict", r) == 93.75
    assert read("entry_host_ms.predict", r) is None              # no root: the parent is gone


def test_readers_refuse_a_missing_root_or_a_span_outside_the_window(monkeypatch):
    span_metrics = [m["name"] for m in SPEC["per_layer"]
                    if m["name"].split(".")[0] in ("forward_host_ms", "backward_host_ms",
                                                   "optimizer_host_ms", "entry_host_ms",
                                                   "entry_idle_pct")]
    assert len(span_metrics) == 9
    r = readings(TRAIN_SPANS, monkeypatch, items=2)             # two steps traced, one root
    assert all(read(m, r) is None for m in span_metrics)
    late = TRAIN_SPANS[:-1] + [(5, "train.adamw", 80, 101, 0, 0)]
    r = readings(late, monkeypatch)
    assert all(read(m, r) is None for m in span_metrics)
    r = readings(TRAIN_SPANS, monkeypatch, window=(5, 95))      # every span inside
    assert read("forward_host_ms.train", r) == pytest.approx(28)
    earlier = [(9, "train.step", -50, -40, -1, 9)] + TRAIN_SPANS  # another session's
    assert read("forward_host_ms.train", readings(earlier, monkeypatch)) == pytest.approx(28)
    monkeypatch.delattr(profiling, "spans")                     # a program without spans
    assert all(read(m, r) is None for m in span_metrics)


def test_counter_readers_need_their_counters(monkeypatch):
    r = readings(TRAIN_SPANS, monkeypatch)
    assert read("ext_call_us.train", r) is None
    r.counters = {"bn_relu": 3}                                  # a program without them
    assert read("ext_call_us.train", r) is None
    r.counters = {"ext_calls": 400, "ext_call_ns": 4_000_000}
    assert read("ext_call_us.train", r) == 10.0


def test_the_programs_breakdown_splits_idle_by_innermost_span():
    spans = [program_spans.Span(*s) for s in TRAIN_SPANS]
    assert union_intervals([(10, 20), (15, 30), (60, 70)]) == [(10, 30), (60, 70)]
    tracer = Tracer()
    tracer.start_ns, tracer.end_ns = 0, 100
    tracer.events = [("k", 10, 20), ("k", 15, 30), ("k", 60, 70)]
    total, held = program_spans.idle_ns(SimpleNamespace(tracer=tracer), spans)
    assert total == 10 + 30 + 30
    assert held == {0: 5, 1: 5, 2: 10, 3: 20, 4: 10, 5: 10}
