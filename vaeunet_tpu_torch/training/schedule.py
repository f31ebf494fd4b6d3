"""Host-side ReduceLROnPlateau controller.  A copy of
``vaeunet_tpu/training/schedule.py``.

``torch.optim.lr_scheduler.ReduceLROnPlateau`` as the reference configures
it (train.py:324-342): mode='max' on validation Dice, factor 0.5 (0.7 for
MA), patience 5 (8 for MA), min_lr 1e-6 (1e-5 for MA).  It returns the new
learning rate, which ``training.state.set_learning_rate`` writes into the
optimizer's param groups between steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-6
    mode: str = "max"
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0

    best: float = field(default=None, init=False)
    num_bad_epochs: int = field(default=0, init=False)
    cooldown_counter: int = field(default=0, init=False)

    @classmethod
    def for_lesion(cls, lesion_type: str) -> "ReduceLROnPlateau":
        """Reference per-lesion schedule selection (train.py:322-342)."""
        if lesion_type == "MA":
            return cls(factor=0.7, patience=8, min_lr=1e-5)
        return cls(factor=0.5, patience=5, min_lr=1e-6)

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            eps = abs(self.best) * self.threshold
        else:
            eps = self.threshold
        if self.mode == "max":
            return metric > self.best + eps
        return metric < self.best - eps

    def step(self, metric: float, current_lr: float) -> float:
        """Record a validation metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = float(metric)
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter,
                "factor": self.factor, "patience": self.patience,
                "min_lr": self.min_lr}

    def load_state_dict(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)
