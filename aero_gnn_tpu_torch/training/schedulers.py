"""Host-side schedulers: ReduceLROnPlateau + early stopping (the port's own
copy of aero_gnn_tpu.training.schedulers).

Re-implementations of the torch schedulers the reference trains with, as
plain state machines stepped once per epoch; the learning rate they return
is set on the optimizer by ``training.loop.set_learning_rate``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    relative threshold 1e-4, cooldown 0: the torch defaults)."""

    lr: float
    factor: float = 0.8
    patience: int = 50
    min_lr: float = 1e-7
    threshold: float = 1e-4

    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


@dataclasses.dataclass
class EarlyStopping:
    """Counter-on-no-improvement early stop: strict '<' improvement, stop
    when the counter exceeds the patience."""

    patience: int = 200
    best: float = float("inf")
    counter: int = 0
    should_stop: bool = False

    def step(self, metric: float) -> bool:
        if metric < self.best:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
            if self.counter > self.patience:
                self.should_stop = True
        return self.should_stop
