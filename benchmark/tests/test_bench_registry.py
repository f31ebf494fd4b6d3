"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a cell and a metric that are added as new files."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness.readings import Readings
from benchmark.harness.registry import Registry
from benchmark.tests.tiny import ROOT, run_cell, tiny_registry

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_files():
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and (ROOT / c["file"]).is_file()
        assert (ROOT / "benchmark" / "configs" / f"{c['name']}.py").is_file()
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layers
        for m in layers:       # the end-to-end metric it moves is one this cell reports
            assert m["moves"] in {x["name"] for x in mine}
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_configuration_cell_and_metric_are_found_as_new_files(tmp_path, capsys):
    registry = tiny_registry(tmp_path)
    root = registry.root
    before = _digest(root)
    cfg = json.loads((root / "configs" / "vaeunet_r34.json").read_text())
    cfg["name"] = "vaeunet_r18"
    cfg["backbone"], cfg["encoder_stages"] = "resnet18", [2, 2, 2, 2]
    (root / "configs" / "vaeunet_r18.json").write_text(json.dumps(cfg))
    (root / "configs" / "vaeunet_r18.py").write_text(
        (root / "configs" / "vaeunet_r34.py").read_text())
    (root / "traffic" / "train-b2.json").write_text(json.dumps(
        {**json.loads((root / "traffic" / "train-b16.json").read_text()), "batch": 2,
         "pool": 8}))
    shutil.copy(root / "limits" / "vaeunet_r34-train-b16.json",
                root / "limits" / "vaeunet_r18-train-b2.json")
    (root / "metrics" / "steps_seen.train.py").write_text(
        "def read(r):\n    return r.items if r.kind == 'train' else None\n")
    spec = json.loads(json.dumps(registry.spec))
    spec["configs"].append({**spec["configs"][0], "name": "vaeunet_r18",
                            "file": "benchmark/configs/vaeunet_r18.json"})
    spec["workloads"].append({"name": "vaeunet_r18-train-b2", "config": "vaeunet_r18",
                              "traffic": "train-b2", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("vaeunet_r18-train-b2")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "training entry",
                              "moves": "train_img_per_s",
                              "workloads": ["vaeunet_r18-train-b2"]})
    registry.spec = spec

    result = run_cell(registry, "vaeunet_r18-train-b2", capsys=capsys)
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
    assert result["attempted"] >= 1 and set(result["checks"]) == {
        "loss_gap", "grad_median_gap", "change_gap"}
    layer = registry.per_layer("vaeunet_r18-train-b2")
    assert [m["name"] for m in layer][-1] == "steps_seen.train"
    assert registry.read(layer[-1], Readings(kind="train", precision="bf16", items=7)) == 7
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    registry = Registry(SPEC)
    empty = Readings(kind="uq", precision="fp32")
    for m in SPEC["per_layer"]:
        assert registry.read(m, empty) is None, m["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_roofline_and_mfu_readers_do_not_cap(metric):
    text = (ROOT / "benchmark" / "metrics" / f"{metric}.py").read_text()
    assert "min(" not in text
