"""The frozen reference against ``vaeunet_tpu_torch`` at a tiny size on the
CPU, on the same seeded weights and inputs (this test imports both; the
reference imports nothing of the program)."""

from __future__ import annotations

import ast

import pytest
import torch

from benchmark.harness import compare, seeds, weights
from benchmark.reference.unet import UNet
from benchmark.reference.vae_unet import VAEUNet
from benchmark.tests.tiny import ROOT, tiny_registry

torch.set_num_threads(2)


def _weights(model_fn, serving: bool, seed: int = 7):
    with torch.device("meta"):
        shapes = model_fn()
    return weights.make(shapes, seed, "cpu", serving=serving)


def test_reference_imports_torch_alone():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module]
                for n in names:
                    assert n.split(".")[0] in ("torch", "typing", "math", "__future__",
                                               "benchmark"), (path.name, n)
                    assert not n.startswith("benchmark.") or n.startswith(
                        "benchmark.reference"), (path.name, n)


def test_vae_unet_forward_agrees():
    from vaeunet_tpu_torch.models.vae_unet import build_model

    w = _weights(VAEUNet, serving=True)
    prog = weights.load(build_model(seed=0, device="cpu"), w).eval()
    ref = weights.load(VAEUNet(), w).eval()
    x = torch.rand((2, 3, 64, 96), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lp, mp, vp = prog(x.contiguous(memory_format=torch.channels_last), sample=False)
        lr, mr, vr = ref(x, torch.zeros((2, 32)))
    for a, b in ((lp, lr), (mp, mr), (vp, vr)):
        assert compare.widest_gap(a, b) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_unet_forward_agrees():
    from vaeunet_tpu_torch.models.unet import build_unet

    w = _weights(UNet, serving=True)
    prog = weights.load(build_unet(3, 1, device="cpu"), w).eval()
    ref = weights.load(UNet(), w).eval()
    x = torch.rand((2, 3, 48, 48), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        gap = compare.widest_gap(prog(x.contiguous(memory_format=torch.channels_last)), ref(x))
    assert gap <= 1e-5


@pytest.mark.parametrize("config", ["vaeunet_r34", "unet_milesial"])
def test_fp32_train_steps_agree(tmp_path, config):
    """The program's step in float32 (amp off) follows the reference: the
    first step's loss to float32 rounding, every leaf's first gradient to
    1e-2 of the median leaf; the changes after three AdamW steps, whose
    first steps are sign-like, to a tenth."""
    reg = tiny_registry(tmp_path)
    cfg = reg.config(config)
    cfg["train"]["amp"] = False
    d = reg.driver("train").Driver(cfg, reg.config_module(config), reg.traffic("train-b16"),
                                   seeds.derive(3, 1), "cpu")
    d.setup()
    d.release()
    ref = d.follow_reference()
    assert abs(d.program["loss"][0] - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    numbers = compare.train_numbers(d.program, ref)
    worst = max(compare.leaf_gaps(d.program["grad"], ref["grad"], list(ref["grad"])))
    assert worst <= 1e-2, numbers
    assert numbers["change_gap"] <= 0.1, numbers


@pytest.mark.parametrize("workload,gaps", [("vaeunet_r34-uq-fundus-n10", ("samples_gap",
                                                                          "maps_gap")),
                                           ("vaeunet_r34-predict-carvana", ("probs_gap",))])
def test_tiled_requests_agree(tmp_path, workload, gaps):
    reg = tiny_registry(tmp_path)
    cell = reg.workload(workload)
    d = reg.driver(reg.traffic(cell["traffic"])["kind"]).Driver(
        reg.config(cell["config"]), reg.config_module(cell["config"]),
        reg.traffic(cell["traffic"]), 11, "cpu")
    d.setup()
    for i in sorted(d.keep):
        d.kept[i] = d._timed(i)[0]
    d.release()
    numbers = d.check()
    assert set(numbers) == set(gaps)
    assert all(v <= 1e-5 for v in numbers.values()), numbers
