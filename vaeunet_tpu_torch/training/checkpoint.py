"""Checkpoints with true resume, on ``torch.save``.  Port of
``vaeunet_tpu/training/checkpoint.py`` (which uses orbax).

A checkpoint holds the whole training state: the model's state dict with
its BN buffers, ``ClippedAdamW.state_dict()``, the noise generator's state
(``state.generator.get_state()``), the step, and the host controller state
(plateau scheduler, epoch, best score, early-stopping count, and the
loader's and the evaluation's random streams), so a resumed run draws the
noise and the augmentation that the unbroken run would have drawn.

Layout (the JAX package's, reference train.py:62-108,535-541):
  <checkpoint_dir>/<encoded-hparams>/     ``config.checkpoint_path()``
      <name>/state.pt     ``best``, ``model_<ts>_ep<e>_dice<d>``, ``best_preresume``
      config.json         TrainConfig
      host_state.json     the JSON part of the host state of the last save

Saves are synchronous: the state is written to a temporary file beside the
target and renamed over it, so an interrupted save leaves the previous
checkpoint whole.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from vaeunet_tpu_torch.training.config import TrainConfig
from vaeunet_tpu_torch.training.state import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def wait_for_saves() -> None:
    """For the JAX package's API: its saves are asynchronous, these are
    written before :func:`save_checkpoint` returns."""


def save_checkpoint(run_dir: str, state: TrainState, config: TrainConfig,
                    host_state: Optional[Dict[str, Any]] = None,
                    rng_state: Optional[Dict[str, Any]] = None,
                    name: str = "best") -> str:
    """Write `state`, `host_state` (JSON-able) and `rng_state` (host random
    streams: tensors, numbers) to ``<run_dir>/<name>/state.pt``; -> that
    directory."""
    run = Path(run_dir).absolute()
    path = run / name
    path.mkdir(parents=True, exist_ok=True)
    (run / "config.json").write_text(config.to_json())
    if host_state is not None:
        (run / "host_state.json").write_text(json.dumps(host_state))
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "generator": state.generator.get_state(),
               "step": int(state.step),
               "host": dict(host_state or {}),
               "rng": dict(rng_state or {})}
    tmp = path / f".{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)
    log.info("Saved checkpoint to %s", path)
    return str(path)


def restore_checkpoint(run_dir: str, state: TrainState, name: str = "best"
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """Load ``<run_dir>/<name>`` into `state` (its model, optimizer and
    generator, in place) -> (state, host_state); the host random streams
    are under ``host_state["rng"]``."""
    path = Path(run_dir).absolute() / name / STATE_FILE
    # loaded to the host: the model and AdamW copy their tensors to the
    # parameters' device, and AdamW keeps its step counts on the host, as a
    # fresh one does
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    host_state = dict(payload["host"])
    host_state["rng"] = payload["rng"]
    return state, host_state


def load_model_state(run_dir: str, name: str = "best", device=None) -> Dict[str, torch.Tensor]:
    """The model's state dict alone from a checkpoint of this package."""
    path = Path(run_dir).absolute() / name / STATE_FILE
    return torch.load(path, map_location=device or "cpu", weights_only=True)["model"]


def is_checkpoint(run_dir: str, name: str = "best") -> bool:
    return (Path(run_dir) / name / STATE_FILE).exists()


def load_config(run_dir: str) -> Optional[TrainConfig]:
    p = Path(run_dir) / "config.json"
    if p.exists():
        return TrainConfig.from_json(p.read_text())
    return None


def latest_run_dir(config: TrainConfig) -> str:
    return config.checkpoint_path()
