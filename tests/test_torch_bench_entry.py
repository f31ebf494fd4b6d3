"""The port's benchmark entry points (``python -m vaeunet_tpu_torch.cli.bench``
and ``cli.bench_tiled``), at a small size on the CPU: each prints one JSON
line of the shape its JAX script prints (``bench.py``,
``scripts/bench_tiled.py``) and returns it; ``vs_baseline`` divides by
``bench_baseline.json``, which is read and never written, and a missing
baseline is an error before anything is measured; there is no fallback."""

import json
from pathlib import Path

import pytest
import torch

from vaeunet_tpu_torch.cli import bench, bench_tiled
from vaeunet_tpu_torch.inference.tiled import compute_tile_grid

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_bench_prints_the_headline_line(capsys):
    before = (REPO / "bench_baseline.json").read_bytes()
    report = {}
    line = bench.main(["--device", "cpu"], batch=2, hw=64, steps=2, warmup=1, report=report)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == line
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "images_per_sec_per_chip_512sq_vaeunet_train"
    assert line["unit"] == "img/s" and line["value"] > 0
    base = json.loads(before)["torch_cpu_img_per_sec"]
    assert line["vs_baseline"] == round(2 * 2 / sum(report["step_s"]) / base, 2)
    assert len(report["step_s"]) == len(report["loss"]) == 2
    assert all(0 < v < 1e6 for v in report["loss"])
    assert (REPO / "bench_baseline.json").read_bytes() == before


def test_bench_defaults_are_the_scripts():
    assert (bench.HW, bench.BATCH, bench.STEPS, bench.WARMUP) == (512, 16, 10, 3)
    assert bench.BASELINE_FILE == REPO / "bench_baseline.json"
    assert (bench_tiled.H, bench_tiled.W, bench_tiled.PATCH, bench_tiled.TILE_BATCH,
            bench_tiled.RUNS) == (1280, 1918, 512, 8, 7)


def test_a_missing_baseline_is_an_error_before_any_step(tmp_path, monkeypatch):
    def never(**kw):
        raise AssertionError("measured without a baseline")

    monkeypatch.setattr(bench, "measure", never)
    monkeypatch.setattr(bench, "BASELINE_FILE", tmp_path / "bench_baseline.json")
    with pytest.raises(FileNotFoundError, match="bench_baseline.json"):
        bench.main(["--device", "cpu"])
    assert not (tmp_path / "bench_baseline.json").exists()


def test_a_failing_step_fails_the_bench(monkeypatch):
    """No retry and no smaller batch: the first failure is the result."""
    calls = []

    def fail(**kw):
        calls.append(kw)
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(bench, "measure", fail)
    with pytest.raises(RuntimeError, match="out of memory"):
        bench.main(["--device", "cpu"])
    assert calls == [{"device": "cpu"}]


def test_bench_tiled_prints_the_p50_line(capsys):
    report = {}
    line = bench_tiled.main(["--device", "cpu"], h=80, w=112, patch=64, batch=2, runs=3,
                            report=report)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert list(line) == ["metric", "value", "unit", "tiles"]
    assert line["metric"] == "tiled_inference_p50_latency_112x80" and line["unit"] == "ms"
    assert line["tiles"] == len(compute_tile_grid(80, 112, 64)) == 6
    assert line["value"] == round(sorted(report["latency_s"])[1] * 1e3, 1)


def test_the_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.measure()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_tiled.measure()
