"""The port's data-parallel training loop (``parallel/dp.py::train_model_dp``
through ``run_train_dp``, and the train CLI's ``--num-devices``) on two
gloo ranks on the CPU, on ``tests/test_torch_loop.py``'s synthetic set.

JAX's own ``test_train_model_dp_end_to_end`` asks for a positive step and
a validation Dice in the tracking; here, beside that, an epoch of
``train_model_dp`` equals an epoch of the one-process ``train_model`` on
the same config (host-fed, the same seeded batches, augmentation and
noise: the global-batch step is the one-rank step to rounding), within
the harness bounds of one step (parameters 2 lr, running statistics 1e-4
+ 1e-3 |ref|); and a resumed data-parallel run equals the unbroken one
bit for bit (one epoch is one step, so ``best`` is the epoch's end).
The ranks run in fresh processes; no process group in this one.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from vaeunet_tpu_torch.cli import train as cli
from vaeunet_tpu_torch.data import IDRIDDataset
from vaeunet_tpu_torch.parallel.dp import run_train_dp
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, restore_checkpoint
from vaeunet_tpu_torch.training import train_model
from vaeunet_tpu_torch.utils.tracking import Tracker

LR = 1e-3


@pytest.fixture(autouse=True)
def _no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)          # as the ranks run
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """tests/test_loop.py's set: bright lesion blobs on a dark field."""
    root = tmp_path_factory.mktemp("idrid_dp")
    rng = np.random.RandomState(0)
    for split, n in (("train", 3), ("val", 2)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            yy, xx = np.mgrid[0:64, 0:64]
            cy, cx = rng.randint(20, 44), rng.randint(20, 44)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 80
            img = np.full((64, 64, 3), 40, np.uint8)
            img[blob] = 220
            mask = np.zeros((64, 64), np.uint8)
            mask[blob] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.chdir(tmp_path)                    # the tracker writes ./runs


def one_step_config(root, tmp_path, **kw) -> TrainConfig:
    """One image's patches and an even batch above half of them: an epoch
    is one step, batch / 2 rows a rank."""
    n = len(IDRIDDataset(str(root), split="train", scale=1.0, patch_size=32, lesion_type="EX",
                         max_images=1, balance_seed=0))
    batch = n - n % 2
    assert batch > n / 2 and batch >= 2
    base = dict(model_type="resnet", backbone="resnet18", latent_dim=8, epochs=2,
                batch_size=batch, gradient_accumulation_steps=1, learning_rate=LR, amp=False,
                data_dir=str(root), img_scale=1.0, patch_size=32, lesion_type="EX", seed=0,
                max_images=1, checkpoint_dir=str(tmp_path / "ckpt"), kl_anneal_epochs=2,
                early_stopping_patience=100, num_devices=2)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def runs(synth_root, tmp_path_factory):
    """Two epochs unbroken; one epoch; a resume of it to the second."""
    tmp = tmp_path_factory.mktemp("dp_runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VAEUNET_CACHE_DIR", str(tmp / "cache"))
        mp.chdir(tmp)                              # the ranks' tracker writes ./runs
        cfg = one_step_config(synth_root, tmp, checkpoint_dir=str(tmp / "ckpt_a"))
        unbroken = run_train_dp(cfg, device="cpu", timeout=300)
        first = dataclasses.replace(cfg, epochs=1, checkpoint_dir=str(tmp / "ckpt_b"))
        one = run_train_dp(first, device="cpu", timeout=300)
        resumed = run_train_dp(dataclasses.replace(first, epochs=2), device="cpu",
                               timeout=300, resume_from=first.checkpoint_path())
    return tmp, first, unbroken, one, resumed


def test_dp_epoch_trains_and_checkpoints(runs):
    _, first, unbroken, one, _ = runs
    assert one["step"] == 1 and unbroken["step"] == 2
    state, host = restore_checkpoint(first.checkpoint_path(),
                                     create_train_state(first, seed=1, device="cpu"))
    assert host["epoch"] == 1 and host["global_step"] == 1 == state.step
    for k, v in one["model"].items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_dp_epoch_equals_the_one_process_epoch(runs, tmp_path):
    """The same config in one process (host-fed, as DP is): the same
    batches, augmentation and noise, the global-batch step."""
    _, first, _, one, _ = runs
    single = dataclasses.replace(first, num_devices=1, device_cache=False,
                                 checkpoint_dir=str(tmp_path / "ckpt_1"))
    state = train_model(single, tracker=Tracker(run_dir=str(tmp_path / "r1")), device="cpu")
    assert state.step == one["step"]
    for k, v in state.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(one["model"][k], v)
        elif "running_" in k:
            torch.testing.assert_close(one["model"][k], v, atol=1e-4, rtol=1e-3, msg=k)
        else:
            torch.testing.assert_close(one["model"][k], v, atol=2 * LR + 1e-6, rtol=0, msg=k)


def test_dp_resume_equals_the_unbroken_run(runs):
    """1 epoch + resume + 1 epoch = 2 epochs, bit for bit: every rank
    restores the weights, the optimizer and the generator from rank 0's
    checkpoint (JAX ``test_dp_resume_equals_uninterrupted``)."""
    _, _, unbroken, _, resumed = runs
    assert resumed["step"] == unbroken["step"] == 2
    for k, v in unbroken["model"].items():
        assert torch.equal(resumed["model"][k], v), k


def test_only_rank_zero_tracks(runs):
    """One tracking run per data-parallel run (rank 0's), each with the
    validation Dice (JAX ``test_train_model_dp_end_to_end``)."""
    dirs = sorted((runs[0] / "runs").iterdir())
    assert len(dirs) == 3
    for d in dirs:
        assert any("val/dice" in ln for ln in (d / "metrics.jsonl").read_text().splitlines())


def test_cli_num_devices_trains_on_two_ranks(synth_root, tmp_path):
    """``--num-devices 2 --device cpu``: two gloo ranks train an epoch of
    the train CLI's default model; rank 0 writes the run and the tracking."""
    args = ["--data-dir", str(synth_root), "--scale", "1", "--patch-size", "32",
            "--batch-size", "2", "--gradient-accumulation-steps", "1", "--no-amp",
            "--max-images", "1", "--epochs", "1", "--num-devices", "2",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    out = cli.main(args)
    config = cli.config_from_args(cli.get_parser().parse_args(args))
    assert out["step"] > 0 and config.num_devices == 2
    _, host = restore_checkpoint(config.checkpoint_path(),
                                 create_train_state(config, seed=1, device="cpu"))
    assert host["global_step"] <= out["step"]
    runs_dir = tmp_path / "runs"
    metrics = [json.loads(ln) for d in runs_dir.iterdir()
               for ln in (d / "metrics.jsonl").read_text().splitlines()]
    assert len(list(runs_dir.iterdir())) == 1
    assert any("val/dice" in m for m in metrics)
