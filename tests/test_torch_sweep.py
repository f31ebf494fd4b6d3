"""The port's offline sweep (``python -m vaeunet_tpu_torch.cli.sweep``)
against ``scripts/run_sweep.py``: the same search space, the same trial
configs from the same seed (``random.Random``), the script's flags plus
``--device``; two one-epoch trials of the real space train on a synthetic
IDRiD set and are recorded ``ok`` with the script's keys; a failing trial
is recorded as an error and the sweep goes on, as in the script.
"""

import argparse
import importlib.util
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vaeunet_tpu_torch.cli import sweep

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("_script_run_sweep", REPO / "scripts" / "run_sweep.py")
JAX_SWEEP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JAX_SWEEP)

# a seed whose first two trials are batch 2, scale 0.25, patch 256: trials
# that fit a test's time on the CPU
SEED = 31
KEYS = ["trial", "batch_size", "epochs", "scale", "learning_rate", "patch_size", "free_bits",
        "kl_anneal_epochs", "best_val_dice", "status", "seconds"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("WANDB_MODE", "disabled")
    monkeypatch.chdir(tmp_path)           # ./runs, ./checkpoints, sweep_results.jsonl


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """Fundus-coloured 1536^2 fields with exudate blobs: at scale 0.25 each
    image gives four 256^2 patches (stride 128), some with lesions."""
    root = tmp_path_factory.mktemp("idrid_sweep")
    rng = np.random.RandomState(0)
    h = w = 1536
    yy, xx = np.ogrid[:h, :w]
    for split, n in (("train", 2), ("val", 1)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            img = (rng.randint(-20, 21, (h, w, 3)) + np.array([150, 70, 30])).clip(0, 255)
            img = img.astype(np.uint8)
            mask = np.zeros((h, w), np.uint8)
            for _ in range(6):
                cy, cx = rng.randint(100, h - 100), rng.randint(100, w - 100)
                blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 40 ** 2
                img[blob] = (230, 210, 90)
                mask[blob] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


@pytest.mark.parametrize("seed", [0, SEED, 12345])
def test_trial_configs_equal_the_script_for_a_seed(seed):
    assert sweep.SPACE == JAX_SWEEP.SPACE
    ours, theirs = random.Random(seed), random.Random(seed)
    for _ in range(10):
        assert sweep.sample_config(ours) == JAX_SWEEP.sample_config(theirs)


def test_parser_has_every_script_option_plus_device():
    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught) as e:
            JAX_SWEEP.main()

    def options(p):
        return {tuple(a.option_strings): (a.dest, a.default, a.type, a.required)
                for a in p._actions if a.option_strings and a.dest != "help"}

    ours = options(sweep.get_parser())
    assert ours.pop(("--device",))[:2] == ("device", None)
    assert ours == options(e.value.args[0])


def test_two_one_epoch_trials_end_ok(synth_root, tmp_path):
    results = sweep.main(["--trials", "2", "--data-dir", str(synth_root), "--max-epochs", "1",
                          "--max-images", "2", "--seed", str(SEED), "--device", "cpu"])
    records = [json.loads(ln) for ln in (tmp_path / "sweep_results.jsonl").read_text().splitlines()]
    rng = random.Random(SEED)
    drawn = [JAX_SWEEP.sample_config(rng) for _ in range(2)]
    assert [r["trial"] for r in records] == [0, 1]
    for rec, hp in zip(records, drawn):
        assert list(rec) == KEYS and rec["status"] == "ok", rec
        assert {k: rec[k] for k in hp} == {**hp, "epochs": 1}
        assert 0.0 <= rec["best_val_dice"] <= 1.0
        assert (hp["batch_size"], hp["scale"], hp["patch_size"]) == (2, 0.25, 256)
    assert sorted(r["trial"] for r in results) == [0, 1]
    assert [r["best_val_dice"] for r in results] == sorted(
        (r["best_val_dice"] for r in records), reverse=True)
    for i in range(2):
        runs = list((tmp_path / "runs" / f"sweep_{i}").iterdir())
        assert len(runs) == 1 and "val/dice" in (runs[0] / "metrics.jsonl").read_text()
        assert any((tmp_path / "checkpoints" / f"sweep_{i}").rglob("state.pt"))


def test_a_failing_trial_is_recorded_and_the_sweep_goes_on(synth_root, tmp_path, monkeypatch):
    import vaeunet_tpu_torch.training.loop as loop

    calls = []

    def fail_first(config, **kw):
        calls.append(config.seed)
        if len(calls) == 1:
            raise RuntimeError("out of memory")
        kw["tracker"].log({"val/dice": 0.25}, step=1)

    monkeypatch.setattr(loop, "train_model", fail_first)
    sweep.main(["--trials", "2", "--data-dir", str(synth_root), "--seed", "3",
                "--device", "cpu", "--out", "results.jsonl"])
    records = [json.loads(ln) for ln in (tmp_path / "results.jsonl").read_text().splitlines()]
    assert calls == [3, 4]
    assert records[0]["status"] == "error: out of memory" and records[0]["best_val_dice"] == 0.0
    assert records[1]["status"] == "ok" and records[1]["best_val_dice"] == 0.25
