"""The port's training loop end to end on the CPU (``tests/test_loop.py``'s
pattern and sizes: latent 8, patch 32, batch 2; resnet18 for time): two
epochs train and checkpoint; a resumed run equals the unbroken one bit for
bit; ``reset_best`` and ``best_preresume`` behave as in JAX; the eval
padding does not bias the metrics."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

from vaeunet_tpu_torch.data import IDRIDDataset, Loader
from vaeunet_tpu_torch.data.device_cache import ImageDeviceCache
from vaeunet_tpu_torch.training import (
    TrainConfig,
    create_train_state,
    evaluate_model,
    load_config,
    make_eval_step,
    restore_checkpoint,
    train_model,
)
from vaeunet_tpu_torch.utils.tracking import Tracker


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """tests/test_loop.py's set: bright lesion blobs on a dark field."""
    root = tmp_path_factory.mktemp("idrid_e2e")
    rng = np.random.RandomState(0)
    for split, n in (("train", 3), ("val", 2)):
        (root / "imgs" / split).mkdir(parents=True)
        (root / "masks" / split / "EX").mkdir(parents=True)
        for i in range(n):
            h, w = 64, 64
            yy, xx = np.mgrid[0:h, 0:w]
            cy, cx = rng.randint(20, 44), rng.randint(20, 44)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < 80
            img = np.full((h, w, 3), 40, np.uint8)
            img[blob] = 220
            mask = np.zeros((h, w), np.uint8)
            mask[blob] = 255
            Image.fromarray(img).save(root / "imgs" / split / f"IDRiD_{i:02d}.jpg")
            Image.fromarray(mask).save(root / "masks" / split / "EX" / f"IDRiD_{i:02d}_EX.tif")
    return root


def config(root, tmp_path, **kw):
    base = dict(model_type="resnet", backbone="resnet18", latent_dim=8, epochs=2, batch_size=2,
                gradient_accumulation_steps=1, learning_rate=1e-3, amp=False,
                data_dir=str(root), img_scale=1.0, patch_size=32, lesion_type="EX", seed=0,
                checkpoint_dir=str(tmp_path / "ckpt"), kl_anneal_epochs=2,
                early_stopping_patience=100)
    base.update(kw)
    return TrainConfig(**base)


def records(tracker, key):
    lines = (tracker.run_dir / "metrics.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in lines if key in ln]


@pytest.fixture(autouse=True)
def _cache_home(tmp_path, monkeypatch):
    monkeypatch.setenv("VAEUNET_CACHE_DIR", str(tmp_path / "cache"))


def test_two_epochs_train_and_checkpoint(synth_root, tmp_path):
    cfg = config(synth_root, tmp_path)
    tracker = Tracker(run_dir=str(tmp_path / "runs"), config={"test": True})
    report = {}
    state = train_model(cfg, tracker=tracker, device="cpu", report=report)
    assert isinstance(report["device_train"], ImageDeviceCache)
    steps = report["steps_per_epoch"]
    assert state.step == 2 * steps and steps > 2
    assert len(report["val_times"]) == 4 and len(report["step_times"]) == 2 * steps

    losses = [r["train/total_loss"] for r in records(tracker, "train/total_loss")]
    assert len(losses) == 2 * steps and all(np.isfinite(losses))
    assert np.mean(losses[steps:]) < np.mean(losses[:steps]), losses
    assert len(records(tracker, "val/dice")) == 4
    assert records(tracker, "latent/active_dims")

    run_dir = cfg.checkpoint_path()
    saved = load_config(run_dir)
    assert saved is not None and saved.lesion_type == "EX" and saved.latent_dim == 8
    fresh = create_train_state(cfg, seed=1, device="cpu")
    restored, host = restore_checkpoint(run_dir, fresh)
    assert host["best_val_score"] > 0 and 1 <= host["epoch"] <= 2
    assert restored.step == host["global_step"] > 0
    assert json.loads((tmp_path / "ckpt" / run_dir.split("/")[-1] / "host_state.json")
                      .read_text())["best_val_score"] == host["best_val_score"]


def one_step_epochs(root, tmp_path, **kw):
    """A config whose epoch is one step (a 1-image train set, batch = its
    size - 1): the end-of-epoch validation is the epoch's only one, so its
    `best` checkpoint is the epoch's end; the shuffle still decides which
    patch sits out."""
    n = len(IDRIDDataset(str(root), split="train", scale=1.0, patch_size=32, lesion_type="EX",
                         max_images=1, balance_seed=0))
    assert n >= 3
    return config(root, tmp_path, max_images=1, batch_size=n - 1, **kw)


def assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["adamw"]["param_groups"] == ob["adamw"]["param_groups"]
    for i, st in oa["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["adamw"]["state"][i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


@pytest.mark.parametrize("device_cache", [True, False], ids=["image-cache", "host-fed"])
def test_resume_equals_the_unbroken_run(synth_root, tmp_path, device_cache):
    """1 epoch + resume + 1 epoch = 2 epochs: parameters, BN buffers, AdamW
    state, generator state and step, bit for bit; the resumed run starts
    at epoch 2.  The host-fed path gives the cache's bits too."""
    cfg = one_step_epochs(synth_root, tmp_path, device_cache=device_cache)
    unbroken = train_model(cfg, tracker=Tracker(run_dir=str(tmp_path / "r0")), device="cpu")

    first = dataclasses.replace(cfg, epochs=1, checkpoint_dir=str(tmp_path / "ckpt_b"))
    train_model(first, tracker=Tracker(run_dir=str(tmp_path / "r1")), device="cpu")
    second = dataclasses.replace(first, epochs=2)
    tracker = Tracker(run_dir=str(tmp_path / "r2"))
    report = {}
    resumed = train_model(second, tracker=tracker, device="cpu",
                          resume_from=first.checkpoint_path(), report=report)
    assert report["start_epoch"] == 2
    assert {r["epoch"] for r in records(tracker, "train/total_loss")} == {2}
    assert_same_state(resumed, unbroken)
    if not device_cache:
        cached = train_model(dataclasses.replace(cfg, device_cache=True, checkpoint_dir=str(
            tmp_path / "ckpt_c")), tracker=Tracker(run_dir=str(tmp_path / "r3")), device="cpu")
        assert_same_state(cached, unbroken)


@pytest.mark.parametrize("reset_best", [False, True])
def test_reset_best_and_best_preresume(synth_root, tmp_path, reset_best):
    cfg = one_step_epochs(synth_root, tmp_path, epochs=1)
    train_model(cfg, tracker=Tracker(run_dir=str(tmp_path / "r1")), device="cpu")
    run_dir = cfg.checkpoint_path()
    _, before = restore_checkpoint(run_dir, create_train_state(cfg, device="cpu"))
    resumed = dataclasses.replace(cfg, epochs=2, reset_best=reset_best)
    tracker = Tracker(run_dir=str(tmp_path / "r2"))
    train_model(resumed, tracker=tracker, device="cpu", resume_from=run_dir)
    # resuming into the same run dir keeps the restored-from weights
    backup, _ = restore_checkpoint(run_dir, create_train_state(cfg, device="cpu"),
                                   name="best_preresume")
    _, host = restore_checkpoint(run_dir, create_train_state(cfg, device="cpu"))
    dice = records(tracker, "val/dice")[-1]["val/dice"]
    improved = reset_best or dice > before["best_val_score"]
    assert host["epoch"] == (2 if improved else 1)
    assert host["best_val_score"] == (dice if improved else before["best_val_score"])
    assert backup.step == before["global_step"]


def test_multi_device_raises(synth_root, tmp_path):
    with pytest.raises(NotImplementedError, match="parallel/"):
        train_model(config(synth_root, tmp_path, num_devices=2), device="cpu")


def test_eval_padding_does_not_bias_metrics():
    """A 5-sample set at batch 4 pads the last batch by repeating samples;
    ``evaluate_model`` masks the padded rows, so its average equals the
    unpadded per-batch metrics (JAX test_eval_padding_does_not_bias_metrics)."""
    rng = np.random.RandomState(3)
    n, hw = 5, 32
    images = rng.rand(n, hw, hw, 3).astype(np.float32)
    masks = (rng.rand(n, hw, hw, 1) > 0.7).astype(np.float32)

    class TinyDS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"image": images[i], "mask": masks[i], "img_id": f"im{i}"}

    cfg = TrainConfig(model_type="resnet", backbone="resnet18", latent_dim=8, batch_size=4,
                      amp=False, patch_size=hw, seed=0)
    state = create_train_state(cfg, seed=0, device="cpu")
    eval_step = make_eval_step(cfg, state.model)
    loader = Loader(TinyDS(), batch_size=4, shuffle=False, drop_last=False)
    got, samples = evaluate_model(eval_step, loader, torch.Generator().manual_seed(1),
                                  max_samples=2)
    assert len(samples) == 2 and samples[0][3] == "im0"
    # the same seeds in the same order; the noise of row i depends only on
    # (seed, i), so the unpadded last batch draws its padded one's first row
    g = torch.Generator().manual_seed(1)
    ref = [eval_step(images[:4], masks[:4], g)[0], eval_step(images[4:], masks[4:], g)[0]]
    for k, v in got.items():
        np.testing.assert_allclose(v, np.mean([r[k].item() for r in ref]), rtol=1e-6,
                                   atol=1e-7, err_msg=f"metric {k} biased by padding")
