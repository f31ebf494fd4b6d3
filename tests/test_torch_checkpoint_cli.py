"""The port's checkpoints (``training/checkpoint.py`` on ``torch.save``) and
its train CLI (``python -m vaeunet_tpu_torch.cli.train``): a checkpoint
gives back the parameters, BN buffers, AdamW state, generator state, step
and host state bit for bit; the CLI's parser has every option and ``dest``
of the top-level ``train.py`` with its defaults; the flags whose module is
not ported raise; the CLI trains, loads and resumes on the CPU."""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import train as jax_train_cli

from vaeunet_tpu_torch.cli import train as cli
from vaeunet_tpu_torch.training import TrainConfig, create_train_state, make_train_step
from vaeunet_tpu_torch.training import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def small_config(tmp_path, **kw):
    return TrainConfig(model_type="resnet", backbone="resnet18", latent_dim=8, batch_size=2,
                       gradient_accumulation_steps=1, amp=False, patch_size=32,
                       learning_rate=1e-3, checkpoint_dir=str(tmp_path / "ckpt"), **kw)


def trained_state(config, steps: int = 2):
    state = create_train_state(config, seed=3, device="cpu")
    step = make_train_step(config, state.model, augment=True)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        images = rng.rand(2, 32, 32, 3).astype(np.float32)
        masks = (rng.rand(2, 32, 32, 1) > 0.8).astype(np.float32)
        state, _ = step(state, images, masks, 0.001)
    return state


def test_checkpoint_round_trip_is_exact(tmp_path):
    config = small_config(tmp_path)
    state = trained_state(config)
    run_dir = checkpoint.latest_run_dir(config)
    assert run_dir == config.checkpoint_path()
    host = {"epoch": 3, "global_step": 2, "best_val_score": 0.25, "no_improvement": 1,
            "scheduler": {"best": 0.25, "num_bad_epochs": 0}}
    rng_state = {"eval_generator": torch.Generator().manual_seed(9).get_state()}
    path = checkpoint.save_checkpoint(run_dir, state, config, host, rng_state)
    checkpoint.wait_for_saves()
    assert path.endswith("/best") and checkpoint.is_checkpoint(run_dir)
    assert checkpoint.load_config(run_dir) == config

    fresh = create_train_state(config, seed=4, device="cpu")
    restored, got = checkpoint.restore_checkpoint(run_dir, fresh)
    rng = got.pop("rng")
    assert got == host and torch.equal(rng["eval_generator"], rng_state["eval_generator"])
    sa, sb = state.model.state_dict(), restored.model.state_dict()
    assert any("running_var" in k for k in sa) and any("num_batches_tracked" in k for k in sa)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert oa["max_norm"] == ob["max_norm"]
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]
    for i, st in oa["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k])
            assert ob["adamw"]["state"][i][k].device == v.device
    assert torch.equal(state.generator.get_state(), restored.generator.get_state())
    assert restored.step == state.step == 2

    # the restored state takes the step the saved one takes
    step_a = make_train_step(config, state.model, augment=True)
    step_b = make_train_step(config, restored.model, augment=True)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    m = (x[..., :1] > 0.5).astype(np.float32)
    _, aux_a = step_a(state, x, m, 0.001)
    _, aux_b = step_b(restored, x, m, 0.001)
    assert torch.equal(aux_a["loss"], aux_b["loss"])
    sa, sb = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)

    weights = checkpoint.load_model_state(run_dir)
    assert weights.keys() == sb.keys()


def jax_parser(monkeypatch):
    """The parser the top-level train.py builds, caught as it parses."""
    caught = {}
    parse = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        return parse(self, [], namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    jax_train_cli.get_args()
    return caught["parser"]


def test_parser_has_every_flag_and_default_of_train_py(monkeypatch):
    theirs = jax_parser(monkeypatch)
    monkeypatch.undo()
    ours = cli.get_parser()

    def table(parser):
        return {a.dest: (tuple(sorted(a.option_strings)), a.default, a.choices)
                for a in parser._actions if a.dest != "help"}

    mine, ref = table(ours), table(theirs)
    assert len([a for a in theirs._actions if a.dest != "help"]) == 45
    for dest, (opts, default, choices) in ref.items():
        assert dest in mine, dest
        assert set(opts) <= set(mine[dest][0]) and mine[dest][1] == default, dest
        assert mine[dest][2] == choices, dest
    assert set(mine) - set(ref) == {"device"}
    # every option of train.py's parses into the same namespace
    argv = ["--epochs", "3", "-b", "4", "--scale", "0.5", "-p", "64", "--no-amp",
            "--no-attention", "--latent-injection", "first", "--device-cache-max-bytes", "7",
            "--oversample-large-lesions", "2.5", "--no-device-cache", "--lesion-type", "MA"]
    a, b = vars(ours.parse_args(argv)), vars(theirs.parse_args(argv))
    a.pop("device")
    assert a == b
    config = cli.config_from_args(ours.parse_args(argv))
    assert (config.patch_size, config.img_scale, config.amp, config.use_attention,
            config.latent_injection, config.device_cache, config.oversample_lesion) == (
        64, 0.5, False, False, "first", False, 2.5)


@pytest.mark.parametrize("argv,what", [
    (["--pretrained-encoder", "enc"], "training/pretrain.py"),
    (["--num-devices", "2"], "parallel/"),
    (["--load", "weights.pth"], "compat/loading.py"),
    (["--load", "no_such_run_dir"], "compat/loading.py"),
])
def test_unported_flags_raise(argv, what):
    with pytest.raises(NotImplementedError, match=what):
        cli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idrid_cli")
    rng = np.random.RandomState(1)
    for split, n in (("train", 1), ("val", 1)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            yy, xx = np.mgrid[0:64, 0:64]
            blob = (yy - rng.randint(20, 44)) ** 2 + (xx - rng.randint(20, 44)) ** 2 < 80
            img = np.full((64, 64, 3), 40, np.uint8)
            img[blob] = 220
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray((blob * 255).astype(np.uint8)).save(
                root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


def test_cli_trains_loads_and_resumes_on_the_cpu(synth_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                       # the tracker writes ./runs
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))
    args = ["--data-dir", str(synth_root), "--scale", "1", "--patch-size", "32",
            "--batch-size", "2", "--gradient-accumulation-steps", "1", "--no-amp",
            "--latent-injection", "first", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--device", "cpu"]
    state = cli.main([*args, "--epochs", "1"])
    assert state.step > 0
    run_dir = cli.config_from_args(cli.get_parser().parse_args(args)).checkpoint_path()
    assert checkpoint.is_checkpoint(run_dir) and (tmp_path / "runs").is_dir()
    loaded = cli.main([*args, "--epochs", "1", "--load", run_dir,
                       "--checkpoint-dir", str(tmp_path / "ckpt2")])
    assert loaded.step == state.step                  # weights only: a new run's steps
    saved = json.loads((Path(run_dir) / "host_state.json").read_text())
    resumed = cli.main([*args, "--epochs", "2", "--resume", run_dir])
    # from `best` (a mid- or end-of-epoch validation of epoch 1) through epoch 2
    assert saved["epoch"] == 1
    assert resumed.step == saved["global_step"] + state.step


def test_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--epochs", "1"])
