"""ReduceLROnPlateau, a host-side LR controller (the JAX package's
``train/schedule.py``; same fields, so ``state_dict`` round-trips between
the two).

Matches torch.optim.lr_scheduler.ReduceLROnPlateau('min') as the reference
uses it (model/train.py:191, stepped on test loss at train.py:168):
factor=0.1, patience=10, threshold=1e-4 (relative), cooldown=0, min_lr=0.
The trainer hands the returned LR to the optimizer (``Trainer.set_lr``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Update with a new validation metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
