"""A copy of the benchmark at sizes the CPU holds: the same files, the same
configurations, limits and drivers, with each traffic mix shrunk (smaller
images and batches, fewer answers checked)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness.registry import Registry

ROOT = Path(__file__).resolve().parents[2]
SMALL = {
    "train-b16": {"hw": 32, "batch": 4, "pool": 16, "trace_steps": 1, "enqueue_steps": 1},
    "uq-fundus-n10": {"image_hw": [100, 150], "patch": 64, "overlap": 16, "samples": 2,
                      "check_requests": 1, "check_among": 1, "ref_tile_batch": 3},
    "predict-carvana": {"image_hw": [90, 120], "patch": 64, "check_requests": 1,
                        "check_among": 1},
}


def tiny_registry(tmp: Path, spec=None, fp32_training: bool = False) -> Registry:
    """A registry over a copy of ``benchmark/`` under `tmp`, its traffic
    shrunk; `spec` replaces ``BENCHMARK.json``'s content.  With
    `fp32_training` the training steps run in float32 at 64^2, where a
    sound step agrees with the reference within the cells' limits (in
    bf16 at a tiny size the batch statistics of a 1x1 bottleneck are
    rounding noise)."""
    root = Path(tmp) / "benchmark"
    shutil.copytree(ROOT / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__"))
    small = {**SMALL, "train-b16": {**SMALL["train-b16"], "hw": 64}} if fp32_training else SMALL
    for name, over in small.items():
        path = root / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    if fp32_training:
        for path in (root / "configs").glob("*.json"):
            cfg = json.loads(path.read_text())
            cfg["train"]["amp"] = False
            path.write_text(json.dumps(cfg))
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    return Registry(spec, root)


def run_cell(registry: Registry, workload: str, seed: int = 2**31 + 17, capsys=None) -> dict:
    """One run of `workload` on the CPU (the look for a chip skipped), one
    second of window -> the result's JSON object."""
    from benchmark import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1",
                   "--trace", "0"], device="cpu", registry=registry)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)
