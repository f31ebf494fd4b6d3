"""Each cell on the card, a short window, traced: correct, and every
per-layer metric of the cell read.  Skips without a CUDA card (the
decision is made in the fixture); run on the H100 with
``python3 -m pytest benchmark/tests/test_bench_card.py -m cuda``."""

from __future__ import annotations

import json

import pytest

from benchmark.tests.tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' kernels run only on the H100")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_traced_on_the_card(card, capsys, workload):
    from benchmark import run

    rc = run.main(["--workload", workload, "--seed", str(2**31 + 5), "--seconds", "3",
                   "--trace", "1"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    expected = {m["name"] for m in SPEC["per_layer"] if workload in m["workloads"]}
    assert set(result["metrics"]) == expected
