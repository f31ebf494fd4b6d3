"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, where the same run unbroken is correct;
and each cell's control, the reference put in the program's place one
precision below the configuration's, fails the cell's limits.  On the CPU
at small sizes (training in float32), the look for a chip skipped; the
limits are the cells' own."""

from __future__ import annotations

import pytest
import torch

from benchmark.calibrate import serving_readings, train_readings
from benchmark.harness.compare import judge
from benchmark.tests.tiny import run_cell, tiny_registry

torch.set_num_threads(2)

TRAIN = ["vaeunet_r34-train-b16", "unet_milesial-train-b16"]
SERVE = ["vaeunet_r34-uq-fundus-n10", "vaeunet_r34-predict-carvana"]


def state_unchanged(monkeypatch):
    from vaeunet_tpu_torch.training.state import ClippedAdamW

    monkeypatch.setattr(ClippedAdamW, "step", lambda self: self.clip_())


def half_batch_loss(monkeypatch):
    from vaeunet_tpu_torch.training import step as step_mod

    real = step_mod.forward_loss

    def half(model, criterion, config, images, masks, beta, generator=None, eps=None,
             group=None):
        b = images.shape[0] // 2
        return real(model, criterion, config, images[:b], masks[:b], beta, generator,
                    None if eps is None else eps[:b], group)

    monkeypatch.setattr(step_mod, "forward_loss", half)


def _patch_decode(monkeypatch, alter):
    from vaeunet_tpu_torch.inference import tiled

    real = tiled._decode_tiles

    def broken(model, batches, z, patch_size, n_tiles):
        return alter(real(model, batches, z, patch_size, n_tiles), batches[0][0].shape[0])

    monkeypatch.setattr(tiled, "_decode_tiles", broken)


def half_tile_batch(monkeypatch):
    def alter(preds, batch):
        keep = (torch.arange(preds.shape[0]) % batch) < max(1, batch // 2)
        return preds * keep.view(-1, 1, 1, 1).to(preds)
    _patch_decode(monkeypatch, alter)


def answer_altered(monkeypatch):
    def alter(preds, _batch):
        preds = preds.clone()
        preds[0, :, :8, :8] += 0.01
        return preds
    _patch_decode(monkeypatch, alter)


def unbroken(monkeypatch):
    pass


@pytest.mark.parametrize("workload,fault", [(w, f) for w in TRAIN
                                            for f in (unbroken, state_unchanged,
                                                      half_batch_loss)]
                         + [(w, f) for w in SERVE
                            for f in (unbroken, half_tile_batch, answer_altered)])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, capsys, workload, fault):
    registry = tiny_registry(tmp_path, fp32_training=True)
    fault(monkeypatch)
    result = run_cell(registry, workload, capsys=capsys)
    assert result["correct"] is (fault is unbroken), result["checks"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_control_fails_the_limits(tmp_path, workload):
    registry = tiny_registry(tmp_path)
    cell = registry.workload(workload)
    traffic = registry.traffic(cell["traffic"])
    d = registry.driver(traffic["kind"]).Driver(
        registry.config(cell["config"]), registry.config_module(cell["config"]), traffic,
        2**31 + 99, "cpu")
    read = train_readings if traffic["kind"] == "train" else serving_readings
    out = read(d, controls=True)
    control = next(v for k, v in out.items() if k.startswith("control_"))
    ok, checks = judge(control, registry.limits(workload))
    assert not ok, checks
