"""The two cells of the EfficientNet-B4 configuration's change on the CPU:
the count of the fused 3x3 sites on the effb4 reference, and the
``train_crops`` driver at tiny sizes (its records, its crop gather against
plain slicing of the seeded images, the checked steps' batches, a whole
run)."""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import flops, seeds
from benchmark.harness.registry import Registry
from benchmark.reference.efficientnet import DepthwiseConv
from benchmark.reference.train import loss_of
from benchmark.tests.tiny import ROOT, run_cell, tiny_registry

torch.set_num_threads(2)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
EFFB4 = "vaeunet_effb4-train-b32"
AUG = "vaeunet_r34-train-aug-b32"
TINY_AUG = {"images": 3, "image_hw": [96, 160], "hw": 64, "batch": 4, "trace_steps": 1,
            "enqueue_steps": 1}


def test_the_effb4_cell_has_the_decoders_8_sites():
    """At the cell's own shape on the meta device, the sites are the
    decoder's 8 dense 3x3 convs: none of the encoder's 3x3 depthwise convs,
    12 of which are stride 1."""
    reg = Registry(SPEC)
    cell = reg.workload(EFFB4)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    b, hw = traffic["batch"], traffic["hw"]
    with torch.device("meta"):
        ref = reg.config_module(cell["config"]).reference_model(cfg).train()
        x, m = torch.empty((b, hw, hw, 3)), torch.empty((b, hw, hw, 1))
        eps = torch.empty((b, 32))
    dw3 = [c for c in ref.encoder.modules() if isinstance(c, DepthwiseConv)
           and c.weight.shape[2:] == (3, 3) and c.stride == (1, 1)]
    assert len(dw3) == 12
    sites = flops.conv3x3_sites(ref, lambda: loss_of(ref, x, m, eps, 0.001, 0.001))
    assert sorted((ci, h, co) for _, ci, h, _, co in sites) == sorted(
        [(640, 32, 512), (512, 32, 512), (600, 64, 256), (256, 64, 256), (320, 128, 128),
         (128, 128, 128), (184, 256, 64), (64, 256, 64)])
    assert all(n == b for n, *_ in sites)


@pytest.fixture
def aug_driver(tmp_path):
    reg = tiny_registry(tmp_path, fp32_training=True)
    cell = reg.workload(AUG)
    traffic = {**reg.traffic(cell["traffic"]), **TINY_AUG}
    driver = reg.driver(traffic["kind"]).Driver(reg.config(cell["config"]),
                                                reg.config_module(cell["config"]), traffic,
                                                2**31 + 41, "cpu")
    return driver


def test_records_are_the_full_overlap_grid(aug_driver):
    aug_driver._data()
    recs = aug_driver.cache.records
    grid = [(y, x) for y in (0, 32) for x in (0, 32, 64, 96)]
    assert [tuple(r) for r in recs] == [(i, y, x) for i in range(3) for y, x in grid]
    assert aug_driver.index.shape[1:] == (4, 3)
    first = aug_driver.index[:aug_driver.checks].reshape(-1, 3)
    assert len({tuple(r) for r in first}) == len(first)      # the checked rows all differ


def test_crop_gather_is_plain_slicing_of_the_seeded_images(aug_driver):
    aug_driver._data()
    g = torch.Generator().manual_seed(seeds.derive(aug_driver.seed, seeds.DATA))
    n, (h, w) = TINY_AUG["images"], TINY_AUG["image_hw"]
    images = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8)
    blobs = torch.rand((n, 1, h // 32, w // 32), generator=g)
    blobs = F.interpolate(blobs, size=(h, w), mode="bilinear", align_corners=False)
    masks = (blobs[:, 0] > aug_driver.traffic["lesion_threshold"]).to(torch.uint8)
    rec = aug_driver.index[5]
    got_i, got_m = aug_driver.cache.make_gather()(aug_driver.images, aug_driver.masks,
                                                  torch.as_tensor(rec))
    p = TINY_AUG["hw"]
    for k, (i, y, x) in enumerate(rec):
        assert torch.equal(got_i[k] * 255.0, images[i, y:y + p, x:x + p].float())
        assert torch.equal(got_m[k, ..., 0], masks[i, y:y + p, x:x + p].float())


def test_checked_steps_hand_the_reference_the_policys_batches(aug_driver, monkeypatch):
    from vaeunet_tpu_torch.training import step as step_mod

    made = []
    real = step_mod.augment_batch

    def spy(generator, images, masks):
        out = real(generator, images, masks)
        made.append(tuple(t.clone() for t in out))
        return out

    monkeypatch.setattr(step_mod, "augment_batch", spy)
    aug_driver.setup()
    assert len(made) == len(aug_driver.batches) == aug_driver.checks
    for (pi, pm), (ri, rm) in zip(made, aug_driver.batches):
        assert torch.equal(pi, ri) and torch.equal(pm, rm)
    assert not torch.equal(made[0][0], made[1][0])


def test_the_aug_cell_runs_correct_on_the_cpu(tmp_path, capsys):
    reg = tiny_registry(tmp_path, fp32_training=True)
    path = reg.root / "traffic" / f"{reg.workload(AUG)['traffic']}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **TINY_AUG}))
    out = run_cell(reg, AUG, capsys=capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_img_per_s", "setup_s"}


def test_the_effb4_cell_runs_correct_on_the_cpu(tmp_path, capsys):
    reg = tiny_registry(tmp_path, fp32_training=True)
    path = reg.root / "traffic" / "train-b32.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "hw": 64, "batch": 4,
                                "pool": 16, "trace_steps": 1, "enqueue_steps": 1}))
    out = run_cell(reg, EFFB4, capsys=capsys)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def test_dwconv_roofline_reads_only_with_depthwise_convs():
    from benchmark.harness.readings import Readings

    reader = Registry(SPEC).reader("dwconv_roofline")

    class Trace:
        def seconds_by_name(self):
            return {"conv2d_c1_k1_nhwc_specialized": 1e-3, "wgrad2d_c1_k1_nhwc": 1e-3,
                    "wgrad2d_shmem_tiling": 5e-3}

    r = Readings(kind="train", precision="bf16", tracer=Trace(), traced_items=1,
                 counters={"dwconv": 2, "dwconv_bytes": 1_000_000_000})
    assert reader.read(r) == pytest.approx(100 * 3 * 1e9 / 3.35e12 / 2e-3)
    r.counters = {"dwconv": 0, "dwconv_bytes": 0}
    assert reader.read(r) is None
    r.counters = {}
    assert reader.read(r) is None
    assert reader.PASSES == 3
