"""Training orchestration.  Port of ``vaeunet_tpu/training/loop.py``
(reference ``train.py:163-621`` and ``evaluate.py:20-101``).

Control flow kept from the JAX loop:
- KL-annealed beta per epoch (train.py:374);
- validation twice an epoch, at mid-epoch and at its end (train.py:436);
- ReduceLROnPlateau on validation Dice (``for_lesion``, with the
  ``lr_patience`` / ``lr_factor`` overrides; train.py:504-506);
- best-Dice checkpoints with the full state in the hyperparameter-encoded
  run dir, optional timestamped snapshots (``save_all_improvements``), and
  *true resume* (``resume_from``, ``reset_best``, ``best_preresume``);
- early stopping counted per validation (train.py:570-579);
- latent posterior-collapse statistics from every fifth batch.

The data path follows ``loop.py:162-186``: with ``config.device_cache`` the
whole set goes to the device as uint8, image-level (``ImageDeviceCache``)
when that is smaller than the patch layout, and the indexed steps gather
each batch there; otherwise (no cache, or over ``device_cache_max_bytes``)
the host ``Loader``'s batches reach the device through pinned memory
(``stage_host_batch``).  Every train step augments on the device.  Per-step
aux stays on the device until a flush point (a validation, the epoch's end):
no host sync a step.

Data parallelism (``parallel/dp.py::train_model_dp``, one call per rank)
comes in through the hooks the JAX loop takes (``loop.py:116-117``):
``train_step``, ``eval_step`` and ``place_batch`` (this rank's rows of a
host batch), with the rank's ``state``; batches are then host-fed, as JAX
feeds them under DP, and only the rank with ``writer`` set writes
checkpoints and tracking.  A config of ``num_devices > 1`` without the
hooks raises: one process is one device.
"""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vaeunet_tpu_torch.data.dataset import LESION_TYPES, IDRIDDataset
from vaeunet_tpu_torch.data.device_cache import (
    DeviceCache,
    ImageDeviceCache,
    estimate_bytes,
    estimate_image_bytes,
    stage_host_batch,
)
from vaeunet_tpu_torch.data.generic import BasicDataset
from vaeunet_tpu_torch.data.loader import Loader
from vaeunet_tpu_torch.device import resolve_device
from vaeunet_tpu_torch.losses import KLAnnealer
from vaeunet_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.schedule import ReduceLROnPlateau
from vaeunet_tpu_torch.training.state import (
    TrainState,
    create_train_state,
    get_learning_rate,
    set_learning_rate,
)
from vaeunet_tpu_torch.training.step import make_eval_step, make_train_step
from vaeunet_tpu_torch.utils.tracking import Tracker
from vaeunet_tpu_torch.vae_utils import calculate_latent_stats

log = logging.getLogger(__name__)


def _loader_rng_state(loader: Loader) -> Dict[str, Any]:
    """The loader's shuffle stream as tensors and numbers (``torch.load``
    with ``weights_only`` reads it back)."""
    _, keys, pos, has_gauss, cached = loader.rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_loader_rng_state(loader: Loader, s: Mapping[str, Any]) -> None:
    loader.rng.set_state(("MT19937", s["keys"].numpy().astype(np.uint32), s["pos"],
                          s["has_gauss"], s["cached_gaussian"]))


def evaluate_model(eval_step, loader: Loader, generator: torch.Generator,
                   max_samples: int = 4, device_data=None,
                   device: Optional[torch.device] = None) -> Tuple[Dict[str, float], List]:
    """Average metrics over the loader's batches and collect up to
    `max_samples` visualization rows (image, probabilities, mask, id)
    (``loop.py:45-116``, evaluate.py:20-101).

    Padded rows of the last batch are left out by a validity mask, so each
    batch's metric equals the reference's true-size batch; batches are
    then averaged with equal weight, as the reference does.  `device_data`:
    a device cache; the batches are then index vectors, gathered by the
    indexed eval step.  The metrics stay on the device until one fetch at
    the end.
    """
    device = device or torch.device("cpu")
    per_batch: List[Dict[str, torch.Tensor]] = []
    samples = []
    b = loader.batch_size
    valid_cache: Dict[int, torch.Tensor] = {}
    for batch in loader:
        count = int(batch["count"])
        if count not in valid_cache:
            valid_cache[count] = torch.as_tensor(
                (np.arange(b) < count).astype(np.float32)).to(device)
        valid = valid_cache[count]
        if device_data is not None:
            metrics, logits = eval_step(device_data.images, device_data.masks,
                                        device_data.batch_indices(batch["idx"]),
                                        generator, valid)
        else:
            images, masks = stage_host_batch(device, batch["image"], batch["mask"])
            metrics, logits = eval_step(images, masks, generator, valid)
        per_batch.append(metrics)
        if len(samples) < max_samples:
            take = min(max_samples - len(samples), count)
            probs = torch.sigmoid(logits[:take]).cpu().numpy()
            if device_data is not None:
                imgs, masks = device_data.fetch(batch["idx"][:take])
                ids = [device_data.img_ids[int(batch["idx"][i])] for i in range(take)]
            else:
                imgs = np.asarray(batch["image"][:take])
                masks = np.asarray(batch["mask"][:take])
                ids = [batch["img_id"][i] for i in range(take)]
            samples.extend((imgs[i], probs[i], masks[i], ids[i]) for i in range(take))
    if not per_batch:
        return {}, []
    keys = list(per_batch[0])
    fetched = torch.stack([torch.stack([m[k] for k in keys]) for m in per_batch]).cpu().numpy()
    return {k: float(np.mean(fetched[:, i])) for i, k in enumerate(keys)}, samples


def make_dataset(config: TrainConfig, split: str):
    """The config's dataset of one split (``loop.py:141-161``)."""
    if config.dataset_type == "basic":
        # Carvana-style layout: <data_dir>/imgs/{train,val} + masks/{train,val}
        return BasicDataset(f"{config.data_dir}/imgs/{split}", f"{config.data_dir}/masks/{split}",
                            scale=config.img_scale, mask_suffix=config.mask_suffix,
                            max_images=config.max_images)
    train = split == "train"
    return IDRIDDataset(config.data_dir, split=split, scale=config.img_scale,
                        patch_size=config.patch_size, lesion_type=config.lesion_type,
                        max_images=config.max_images,
                        balance_seed=config.seed if train else None,
                        oversample_lesion=config.oversample_lesion if train else 0.0)


def choose_device_cache(config: TrainConfig, train_dataset, val_dataset, device):
    """``loop.py:162-186``: (train cache, val cache), image-level when it
    fits and is smaller than the patch layout, else patch-level when that
    fits, else (None, None)."""
    if not config.device_cache:
        return None, None
    est_img_t = estimate_image_bytes(train_dataset)
    est_img_v = estimate_image_bytes(val_dataset)
    est_patch = estimate_bytes(train_dataset) + estimate_bytes(val_dataset)
    if (est_img_t is not None and est_img_v is not None
            and est_img_t + est_img_v <= config.device_cache_max_bytes
            and est_img_t + est_img_v < est_patch):
        log.info("Device-resident data (image-level): %.0f MB", (est_img_t + est_img_v) / 1e6)
        return (ImageDeviceCache(train_dataset, device), ImageDeviceCache(val_dataset, device))
    if est_patch <= config.device_cache_max_bytes:
        log.info("Device-resident data: %.0f MB", est_patch / 1e6)
        return DeviceCache(train_dataset, device), DeviceCache(val_dataset, device)
    log.info("Device cache skipped: %.1f GB exceeds the limit; host-fed batches "
             "through pinned memory", est_patch / 1e9)
    return None, None


class _SilentTracker:
    """The tracker of a rank that writes nothing (every rank of a
    data-parallel run but the writer)."""

    def update_config(self, cfg) -> None:
        pass

    def log(self, metrics, step=None) -> None:
        pass

    def log_image(self, name, image, masks=None) -> None:
        pass

    def summary(self, values) -> None:
        pass

    def finish(self, **final) -> None:
        pass


def train_model(config: TrainConfig, model_state: Optional[Mapping[str, torch.Tensor]] = None,
                tracker: Optional[Tracker] = None, train_dataset=None, val_dataset=None,
                resume_from: Optional[str] = None, device=None,
                report: Optional[Dict[str, Any]] = None, train_step=None, eval_step=None,
                place_batch=None, state: Optional[TrainState] = None,
                writer: bool = True) -> TrainState:
    """Train `config`'s model; -> the final state.  `model_state` (a state
    dict of this package's model) replaces the seeded init; `device`: CUDA
    unless ``"cpu"``.  `report`, a dict the caller passes, receives the
    run's data caches (``device_train``, ``device_val``), ``steps_per_epoch``,
    ``start_epoch``, ``step_times`` (host clock from the end of one step to
    the end of the next, validations left out; the loop makes no sync a
    step, so once the launch queue is full this is the device's rate) and
    ``val_times`` (each validation, ending in its metrics' fetch).

    The data-parallel hooks (module docstring): ``train_step(state, images,
    masks, beta)`` and ``eval_step(images, masks, generator, valid)`` in
    place of the config's steps, ``place_batch(images, masks)`` in place of
    the pinned copy, ``state`` in place of a fresh one (the steps' model);
    ``writer=False`` writes no checkpoint, backup or tracking."""
    report = {} if report is None else report
    hooked = train_step is not None or eval_step is not None or place_batch is not None
    if config.num_devices > 1 and not hooked:
        raise ValueError(
            f"num_devices={config.num_devices}: one process drives one device; run "
            "parallel.train_model_dp in each rank (parallel.launch)")
    device = resolve_device(device)

    if config.lesion_type == "ALL" and config.n_classes == 1:
        config.n_classes = len(LESION_TYPES)      # one output channel per lesion family
        log.info("lesion_type=ALL: n_classes set to %d", config.n_classes)

    train_dataset = train_dataset or make_dataset(config, "train")
    val_dataset = val_dataset or make_dataset(config, "val")
    if len(train_dataset) == 0 or len(val_dataset) == 0:
        raise RuntimeError(f"Empty dataset for lesion type {config.lesion_type}")
    log.info("Dataset sizes: train=%d val=%d", len(train_dataset), len(val_dataset))

    # the steps of the hooks take host-fed batches (loop.py:160-161)
    device_train, device_val = ((None, None) if hooked else
                                choose_device_cache(config, train_dataset, val_dataset, device))
    eff_batch = config.batch_size * max(1, config.gradient_accumulation_steps)
    train_loader = Loader(train_dataset, eff_batch, shuffle=True, seed=config.seed,
                          index_only=device_train is not None)
    val_loader = Loader(val_dataset, config.batch_size, shuffle=False, drop_last=False,
                        index_only=device_val is not None)
    if len(train_loader) == 0:
        raise RuntimeError(f"Train set smaller than effective batch ({eff_batch})")

    if not writer:
        tracker = _SilentTracker()
    tracker = tracker or Tracker(config=dict(
        epochs=config.epochs, batch_size=config.batch_size,
        learning_rate=config.learning_rate, img_scale=config.img_scale,
        amp=config.amp, patch_size=config.patch_size, classes=config.n_classes,
        lesion_type=config.lesion_type, backbone=config.backbone,
        pretrained=config.pretrained, seed=config.seed))

    state = state or create_train_state(config, seed=config.seed, device=device)
    if model_state is not None:
        state.model.load_state_dict(model_state)
    # the evaluation's latent draws (the state's generator is seeded seed + 1)
    eval_generator = torch.Generator().manual_seed(int(config.seed) + 2)
    train_step = train_step or make_train_step(
        config, state.model, augment=True, indexed=device_train is not None,
        gather=device_train.make_gather() if device_train else None)
    eval_step = eval_step or make_eval_step(
        config, state.model, indexed=device_val is not None,
        gather=device_val.make_gather() if device_val else None)

    annealer = KLAnnealer(kl_start=0.0, kl_end=config.beta, warmup_epochs=config.kl_anneal_epochs)
    scheduler = ReduceLROnPlateau.for_lesion(config.lesion_type)
    if config.lr_patience is not None:
        scheduler.patience = config.lr_patience
    if config.lr_factor is not None:
        scheduler.factor = config.lr_factor
    is_vae = config.model_type == "resnet"

    best_val_score = float("-inf")
    no_improvement = 0
    global_step = 0
    start_epoch = 1
    run_dir = config.checkpoint_path()

    if resume_from:
        # params, BN statistics, optimizer moments, the noise generator and
        # the step, plus the host controller and its random streams
        state, host = restore_checkpoint(resume_from, state)
        if not config.reset_best:
            best_val_score = host.get("best_val_score", best_val_score)
            no_improvement = host.get("no_improvement", 0)
        global_step = host.get("global_step", state.step)
        start_epoch = host.get("epoch", 0) + 1
        if "scheduler" in host:
            scheduler.load_state_dict(host["scheduler"])
        rng = host.get("rng", {})
        if "train_loader" in rng:
            _set_loader_rng_state(train_loader, rng["train_loader"])
        if "eval_generator" in rng:
            eval_generator.set_state(rng["eval_generator"])
        log.info("Resumed from %s at epoch %d (step %d, best dice %.4f)",
                 resume_from, start_epoch, global_step, best_val_score)
        # a resumed run that keeps improving overwrites <run_dir>/best; keep
        # the restored-from weights recoverable (loop.py:250-264)
        src = Path(resume_from) / "best"
        if writer and src.resolve() == (Path(run_dir) / "best").resolve() and src.exists():
            backup = Path(run_dir) / "best_preresume"
            if not backup.exists():
                shutil.copytree(src, backup)
                log.info("Backed up pre-resume checkpoint to %s", backup)

    steps_per_epoch = len(train_loader)
    report.update(device_train=device_train, device_val=device_val,
                  steps_per_epoch=steps_per_epoch, start_epoch=start_epoch,
                  step_times=[], val_times=[])
    t_start = time.time()

    def validate(epoch: int) -> bool:
        nonlocal best_val_score, no_improvement
        t0 = time.perf_counter()
        val_metrics, val_samples = evaluate_model(
            eval_step, val_loader, eval_generator, max_samples=4,
            device_data=device_val, device=device)
        report["val_times"].append(time.perf_counter() - t0)
        val_score = val_metrics.get("dice", 0.0)
        lr = get_learning_rate(state)
        new_lr = scheduler.step(val_score, lr)
        if new_lr != lr:
            log.info("Reducing lr %g -> %g", lr, new_lr)
            set_learning_rate(state, new_lr)
        tracker.log({**{f"val/{k}": v for k, v in val_metrics.items()},
                     "learning_rate": new_lr, "epoch": epoch, "step": global_step})
        for i, (img, probs, mask, _) in enumerate(val_samples):
            vis = (img - img.min()) / (img.max() - img.min() + 1e-8)
            tracker.log_image(
                f"step_{global_step}_sample_{i}", vis,
                masks={"predictions": (probs[..., 0] > 0.5).astype(np.uint8),
                       "ground_truth": (mask[..., 0] > 0.5).astype(np.uint8)})
        if val_score > best_val_score:
            best_val_score = val_score
            no_improvement = 0
            if config.save_checkpoint and writer:
                host_state = {"epoch": epoch, "global_step": global_step,
                              "best_val_score": best_val_score,
                              "scheduler": scheduler.state_dict(),
                              "no_improvement": no_improvement}
                rng_state = {"train_loader": _loader_rng_state(train_loader),
                             "eval_generator": eval_generator.get_state()}
                save_checkpoint(run_dir, state, config, host_state, rng_state, name="best")
                if config.save_all_improvements:
                    ts = time.strftime("%Y%m%d_%H%M")
                    save_checkpoint(run_dir, state, config, host_state, rng_state,
                                    name=f"model_{ts}_ep{epoch}_dice{val_score:.4f}")
                log.info("New best model (dice %.4f) saved to %s", val_score, run_dir)
        else:
            no_improvement += 1
        return no_improvement >= config.early_stopping_patience

    for epoch in range(start_epoch, config.epochs + 1):
        beta = annealer.get_weight(epoch)
        log.info("Epoch %d: KL weight (beta) %.6f", epoch, beta)
        epoch_mu: List[torch.Tensor] = []
        epoch_logvar: List[torch.Tensor] = []
        pending: List[Tuple[Dict[str, torch.Tensor], int, int]] = []   # (aux, step, batch)

        def flush_pending():
            """One host fetch for the steps since the last flush."""
            if not pending:
                return
            scalars = torch.stack([torch.stack([a["loss"], a["kl_loss"], a["recon_loss"]])
                                   for a, _, _ in pending]).cpu().numpy()
            for j, (aux, step_no, bidx) in enumerate(pending):
                if bidx % 5 == 0 and is_vae:
                    epoch_mu.append(aux["mu"])
                    epoch_logvar.append(aux["logvar"])
                tracker.log({"train/total_loss": float(scalars[j, 0]),
                             "train/kl_loss": float(scalars[j, 1]),
                             "train/kl_weight": beta,
                             "train/reconstruction_loss": float(scalars[j, 2]),
                             "step": step_no, "epoch": epoch}, step=step_no)
            pending.clear()

        t0 = time.perf_counter()
        for batch_idx, batch in enumerate(train_loader):
            if device_train is not None:
                state, aux = train_step(state, device_train.images, device_train.masks,
                                        device_train.batch_indices(batch["idx"]), beta)
            else:
                images, masks = (place_batch(batch["image"], batch["mask"]) if place_batch
                                 else stage_host_batch(device, batch["image"], batch["mask"]))
                state, aux = train_step(state, images, masks, beta)
            report["step_times"].append(time.perf_counter() - t0)
            global_step += 1
            pending.append((aux, global_step, batch_idx))

            current = batch_idx + 1
            if current == steps_per_epoch // 2 or current == steps_per_epoch:
                flush_pending()
                point = "mid" if current == steps_per_epoch // 2 else "end"
                log.info("Running %s-epoch validation (epoch %d, step %d/%d)",
                         point, epoch, current, steps_per_epoch)
                if validate(epoch):
                    log.info("Early stopping triggered after %d epochs", epoch)
                    tracker.finish(early_stopped=True, final_epoch=epoch)
                    return state
            t0 = time.perf_counter()

        flush_pending()
        if epoch_mu:
            stats = calculate_latent_stats(torch.cat(epoch_mu), torch.cat(epoch_logvar))
            stats = {k: float(v) for k, v in stats.items()}
            tracker.log({f"latent/{k}": v for k, v in stats.items()
                         if k != "total_dims"} | {"epoch": epoch})
            log.info("Latent stats: active %d/%d (%.2f), total KL %.4f",
                     int(stats["active_dims"]), int(stats["total_dims"]),
                     stats["activity_ratio"], stats["total_kl"])

    log.info("Training done in %.1fs (best dice %.4f)", time.time() - t_start, best_val_score)
    tracker.finish()
    return state
