"""Experiment tracking with the reference's W&B surface.  A copy of
``vaeunet_tpu/utils/tracking.py``.

The reference logs per-step scalars, validation image overlays, latent
stats, analysis tables and a config dict to wandb, with an offline fallback
on connection errors (train.py:261-292,417-424,479-499,588-612).  This
Tracker keeps that API: it uses wandb when importable (same offline
fallback), and otherwise writes JSONL + PNGs locally so runs are always
inspectable on machines without network access.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


class Tracker:
    def __init__(self, project: str = "IDRID-UNET", run_dir: str = "./runs",
                 config: Optional[Dict[str, Any]] = None,
                 job_type: str = "train"):
        self.config: Dict[str, Any] = dict(config or {})
        self._wandb = None
        self._step = 0
        try:
            import wandb  # optional
            try:
                self._wandb = wandb.init(project=project, resume="allow",
                                         anonymous="must", job_type=job_type)
            except Exception as e:  # CommError etc -> offline fallback
                log.warning("W&B connection error: %s. Offline mode.", e)
                self._wandb = wandb.init(project=project, resume="allow",
                                         anonymous="must", mode="offline",
                                         job_type=job_type)
            if config:
                self._wandb.config.update(config, allow_val_change=True)
        except ImportError:
            self._wandb = None
        self.run_dir = Path(run_dir) / time.strftime("%Y%m%d_%H%M%S")
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.run_dir / "metrics.jsonl", "a")
        if config:
            (self.run_dir / "config.json").write_text(
                json.dumps(config, default=str, indent=2))

    def update_config(self, cfg: Dict[str, Any]):
        self.config.update(cfg)
        if self._wandb is not None:
            self._wandb.config.update(cfg, allow_val_change=True)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        scalars = {}
        for k, v in metrics.items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                scalars[k] = v
        if self._wandb is not None:
            try:
                self._wandb.log(metrics, step=step)
            except Exception as e:
                log.warning("Could not log to W&B: %s", e)
        rec = {"_step": step if step is not None else self._step,
               "_time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec, default=str) + "\n")
        self._jsonl.flush()
        self._step += 1

    def log_image(self, name: str, image: np.ndarray,
                  masks: Optional[Dict[str, np.ndarray]] = None,
                  step: Optional[int] = None):
        """Validation overlay logging (train.py:479-499).  Locally the image
        and mask layers are stored as PNGs."""
        if self._wandb is not None:
            try:
                import wandb
                wb_masks = None
                if masks:
                    wb_masks = {k: {"mask_data": v.astype(np.uint8),
                                    "class_labels": {1: k}}
                                for k, v in masks.items()}
                self._wandb.log({name: wandb.Image(image, masks=wb_masks)},
                                step=step)
                return
            except Exception as e:
                log.warning("Could not log image to W&B: %s", e)
        try:
            from PIL import Image as PILImage
            out = self.run_dir / "images"
            out.mkdir(exist_ok=True)
            arr = image
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            PILImage.fromarray(arr).save(out / f"{name.replace('/', '_')}.png")
            if masks:
                for k, v in masks.items():
                    PILImage.fromarray((v > 0).astype(np.uint8) * 255).save(
                        out / f"{name.replace('/', '_')}_{k}.png")
        except Exception as e:
            log.warning("Could not save image locally: %s", e)

    def summary(self, values: Dict[str, Any]):
        if self._wandb is not None:
            try:
                for k, v in values.items():
                    self._wandb.summary[k] = v
            except Exception as e:
                log.warning("W&B summary failed: %s", e)
        (self.run_dir / "summary.json").write_text(
            json.dumps(values, default=str, indent=2))

    def finish(self, **final):
        if final:
            self.log(final)
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass
        self._jsonl.close()
