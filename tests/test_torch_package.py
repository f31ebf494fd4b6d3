"""The port's package boundary and device rules: it imports no jax and
nothing of ``vaeunet_tpu``; its entry points never fall back to the CPU
unasked; its kernel wrappers take a CUDA tensor to the kernel or raise."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vaeunet_tpu_torch
from vaeunet_tpu_torch import (
    build_model,
    predict_image,
    predict_tiled_ensemble,
    resolve_device,
    segmentation_distribution,
)
from vaeunet_tpu_torch.ops import _ext
from vaeunet_tpu_torch.ops.pallas import bn_relu, conv_bn_stats, reparam, resize_mm
from vaeunet_tpu_torch.training import TrainConfig
from vaeunet_tpu_torch.training.state import ClippedAdamW

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, vaeunet_tpu_torch, vaeunet_tpu_torch.inference, "
            "vaeunet_tpu_torch.compat, vaeunet_tpu_torch.vae_utils, "
            "vaeunet_tpu_torch.losses, vaeunet_tpu_torch.metrics, vaeunet_tpu_torch.training, "
            "vaeunet_tpu_torch.training.config, vaeunet_tpu_torch.training.state, "
            "vaeunet_tpu_torch.training.step, vaeunet_tpu_torch.training.schedule, "
            "vaeunet_tpu_torch.ops.pallas.conv_bn_stats, vaeunet_tpu_torch.utils.profiling, "
            "vaeunet_tpu_torch.models.parts, vaeunet_tpu_torch.models.unet, "
            "vaeunet_tpu_torch.models.resnet, vaeunet_tpu_torch.ops.remat, "
            "vaeunet_tpu_torch.data, vaeunet_tpu_torch.data.augment, "
            "vaeunet_tpu_torch.data.device_cache, vaeunet_tpu_torch.data.fundus, "
            "vaeunet_tpu_torch.native, vaeunet_tpu_torch.training.loop, "
            "vaeunet_tpu_torch.training.checkpoint, vaeunet_tpu_torch.utils.tracking, "
            "vaeunet_tpu_torch.cli.train, vaeunet_tpu_torch.utils.tensor_utils, "
            "vaeunet_tpu_torch.uncertainty, vaeunet_tpu_torch.compat.torch_weights, "
            "vaeunet_tpu_torch.compat.loading, vaeunet_tpu_torch.inference.ensemble, "
            "vaeunet_tpu_torch.analysis, vaeunet_tpu_torch.analysis.plots, "
            "vaeunet_tpu_torch.analysis.analyze, vaeunet_tpu_torch.analysis.visualize, "
            "vaeunet_tpu_torch.cli.analyze, vaeunet_tpu_torch.cli.visualize, "
            "vaeunet_tpu_torch.cli.evaluate, vaeunet_tpu_torch.cli.predict, "
            "vaeunet_tpu_torch.parallel, vaeunet_tpu_torch.parallel.mesh, "
            "vaeunet_tpu_torch.parallel.dp, vaeunet_tpu_torch.parallel.tp, "
            "vaeunet_tpu_torch.parallel.inference, vaeunet_tpu_torch.ops.collectives, "
            "vaeunet_tpu_torch.training.pretrain, vaeunet_tpu_torch.cli.pretrain, "
            "vaeunet_tpu_torch.cli.member_maps, vaeunet_tpu_torch.cli.tune_fusion, "
            "vaeunet_tpu_torch.cli.scale_ensemble, vaeunet_tpu_torch.cli.sweep, "
            "vaeunet_tpu_torch.cli.bench, vaeunet_tpu_torch.cli.bench_tiled, "
            "vaeunet_tpu_torch.compat.jax_weights; "
            "from vaeunet_tpu_torch.cli import analyze, visualize, evaluate, predict, pretrain, "
            "member_maps, tune_fusion, scale_ensemble, sweep, bench, bench_tiled; "
            "[m.get_parser() for m in (analyze, visualize, evaluate, predict, pretrain, "
            "member_maps, tune_fusion, scale_ensemble, sweep, bench, bench_tiled)]; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'vaeunet_tpu' or m.startswith('vaeunet_tpu.') or m == 'flax'); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_jax_import():
    pkg = Path(vaeunet_tpu_torch.__file__).parent
    for path in [*pkg.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert not stripped.split()[1].startswith(("jax", "flax", "vaeunet_tpu.")), \
                    f"{path}: {stripped}"
                assert stripped.split()[1] != "vaeunet_tpu", f"{path}: {stripped}"


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(backbone="resnet18")
    model = build_model(backbone="resnet18", device="cpu")
    img = np.zeros((64, 64, 3), np.float32)
    with pytest.raises(RuntimeError):
        segmentation_distribution(model, img, torch.Generator(), num_samples=1)
    with pytest.raises(RuntimeError):
        predict_image(model, img)
    with pytest.raises(RuntimeError):
        predict_tiled_ensemble(model, img, torch.zeros(1, 32), patch_size=64)
    assert resolve_device("cpu") == torch.device("cpu")
    # the analysis path's entry points
    from vaeunet_tpu_torch.analysis import AnalyzeArgs, analyze_model
    from vaeunet_tpu_torch.analysis.visualize import (generate_and_compare_ensemble,
                                                      plot_reconstruction,
                                                      visualize_temperature_sampling)
    from vaeunet_tpu_torch.compat import load_model
    from vaeunet_tpu_torch.inference import fused_probability

    class OneImage:
        def unique_image_ids(self):
            return ["a"]

        def get_image_and_mask(self, img_id):
            return img, np.zeros((64, 64, 1), np.float32)

    mask = np.zeros((64, 64, 1), np.float32)
    calls = [
        lambda: analyze_model(model, OneImage(), AnalyzeArgs(output_dir=str(tmp_path))),
        lambda: fused_probability([(model, img)], torch.Generator(), num_samples=1),
        lambda: generate_and_compare_ensemble(model, img, mask, torch.Generator()),
        lambda: plot_reconstruction(model, OneImage(), "a", torch.Generator(), num_samples=1),
        lambda: visualize_temperature_sampling(model, img, mask, torch.Generator()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    torch.save(model.state_dict(), tmp_path / "w.pth")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(str(tmp_path / "w.pth"), overrides={"backbone": "resnet18"})
    loaded, _ = load_model(str(tmp_path / "w.pth"), overrides={"backbone": "resnet18"},
                           device="cpu")
    assert next(loaded.parameters()).device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cuda_call_with_a_cpu_model_raises(monkeypatch):
    """Asked for the card, a model left on the CPU is an error, not a quiet
    CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    model = build_model(backbone="resnet18", device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        predict_image(model, np.zeros((64, 64, 3), np.float32), device="cuda")


def test_wrappers_raise_on_devices_they_do_not_take():
    x = torch.empty((1, 4, 8, 8), device="meta").contiguous(memory_format=torch.channels_last)
    a = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bn_relu.fused_bn_relu(x, a, a, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        resize_mm.resize(x, (16, 16), True)
    with pytest.raises(ValueError, match="unsupported device"):
        resize_mm.resize_backward(x, (4, 4), True)
    with pytest.raises(ValueError, match="unsupported device"):
        conv_bn_stats.conv3x3_bn_stats(x, torch.empty((2, 4, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        reparam.normal((2, 3), 0, "meta")
    with pytest.raises(ValueError, match="64-bit"):
        reparam.normal((2, 3), -1, "cpu")


def test_cpu_path_counts_no_launches():
    _ext.reset_launch_counts()
    x = torch.randn(1, 4, 8, 8).contiguous(memory_format=torch.channels_last)
    resize_mm.resize(x, (16, 16), True)
    bn_relu.fused_bn_relu(x, *(torch.ones(4),) * 4)
    reparam.normal((2, 3), 0, "cpu")
    x.requires_grad_(True)
    resize_mm.resize(x, (16, 16), True).sum().backward()
    y, s, q = conv_bn_stats.conv3x3_bn_stats(x, torch.randn(5, 4, 3, 3))
    (y.sum() + s.sum() + q.sum()).backward()
    ClippedAdamW([x], TrainConfig()).step()               # the CPU's optimizer step
    assert _ext.launch_counts() == {"normal": 0, "reparam": 0, "bn_relu": 0, "resize": 0,
                                    "resize_row": 0, "resize_bwd": 0, "resize_bwd_row": 0,
                                    "conv_bn_stats": 0, "conv_bn_stats_fp32": 0,
                                    "conv_bn_stats_ci8": 0, "bn_train_fwd": 0,
                                    "bn_train_bwd": 0, "clip_adamw_norm": 0,
                                    "clip_adamw_update": 0, "clip_adamw_elems": 0,
                                    "bn_torch": 0, "bn_torch_bytes": 0,
                                    "ext_calls": 0, "ext_call_ns": 0,
                                    "tiles": 0, "tile_slots": 0}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _ext.nvcc_path()


def test_library_names_follow_sources_and_flags():
    paths = {name: _ext.library_path(name) for name in _ext.SIGNATURES}
    assert {p.parent for p in paths.values()} == {_ext.BUILD_DIR}
    assert all(p.name.startswith(f"{n}-") and p.suffix == ".so" for n, p in paths.items())
    assert sorted(p.stem.split("-")[0] for p in _ext.CSRC.glob("*.cu")) == sorted(paths)
    assert "arch=compute_90a,code=sm_90a" in _ext.NVCC_FLAGS


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unet_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    """The plain UNet's factory and serving call keep the device rule."""
    from vaeunet_tpu_torch.models import build_unet
    from vaeunet_tpu_torch.training import TrainConfig, create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_unet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(TrainConfig(model_type="basic"))
    model = build_unet(device="cpu")
    with pytest.raises(RuntimeError):
        predict_image(model, np.zeros((32, 32, 3), np.float32))
    probs, mask = predict_image(model, np.zeros((32, 32, 3), np.float32), device="cpu")
    assert probs.shape == mask.shape == (32, 32, 1)
