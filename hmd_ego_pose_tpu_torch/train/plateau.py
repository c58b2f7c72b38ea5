"""Host-side ReduceLROnPlateau.

A copy of ``hmd_ego_pose_tpu/train/plateau.py``: torch's semantics
(mode 'min', relative threshold, no cooldown) plus ``n_epochs``, the epochs
one metric covers when validation runs every few epochs, which
``torch.optim.lr_scheduler.ReduceLROnPlateau`` lacks.  The trainer steps it
on the validation mixed point-distance mean.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        initial_lr: float,
        factor: float = 0.5,
        patience: int = 15,
        threshold: float = 1e-4,
        min_lr: float = 1e-7,
    ):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float, n_epochs: int = 1) -> float:
        """Record a metric covering ``n_epochs`` epochs; returns the lr.

        ``patience`` counts epochs: when validation runs every ``eval_every``
        epochs, callers pass that count, so a metric that does not improve
        spends ``eval_every`` epochs of patience, not one.
        """
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += n_epochs
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr
