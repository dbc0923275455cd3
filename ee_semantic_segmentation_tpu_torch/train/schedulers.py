"""Host-side learning-rate schedulers: the scalar LR that the train step
hands to ``train/optim.set_lr`` once per epoch.

A copy of ``ee_semantic_segmentation_tpu/train/schedulers.py``, the
reference's two modes (deepv3_funcs.py:138-156):

* polynomial decay ``(1 - k / N)**0.9`` with the ``min_lr`` horizon
  (``w = (min_lr/lr)**(1/.9); N0 = E*w/(1-w); lam = (1 - k/(E+N0))**.9``),
* ``ReduceLROnPlateau(factor=.75, patience=patience//2, eps=1e-6, min_lr)``
  fed the tracked metric (the reference forgot to pass it, SURVEY.md bug
  #6).
"""

from __future__ import annotations


class PolynomialLR:
    def __init__(self, lr: float, num_epochs: int, min_lr: float = 0.0, power: float = 0.9):
        self.lr = lr
        self.power = power
        if min_lr:
            w = (min_lr / lr) ** (1.0 / power)
            n0 = num_epochs * w / (1.0 - w)
            self.horizon = num_epochs + n0
        else:
            self.horizon = num_epochs

    def __call__(self, epoch: int, metric: float | None = None) -> float:
        frac = max(0.0, 1.0 - epoch / self.horizon)
        return self.lr * (frac**self.power)


class ReduceLROnPlateau:
    def __init__(self, lr: float, factor: float = 0.75, patience: int = 10,
                 mode: str = "min", eps: float = 1e-6, min_lr: float = 0.0,
                 threshold: float = 1e-4):
        self.current = lr
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.eps = eps
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf") if mode == "min" else float("-inf")
        self.bad_epochs = 0

    def _improved(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best - self.threshold
        return metric > self.best + self.threshold

    def __call__(self, epoch: int, metric: float | None = None) -> float:
        if metric is None:
            return self.current
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                new = max(self.current * self.factor, self.min_lr)
                if self.current - new > self.eps:
                    self.current = new
                self.bad_epochs = 0
        return self.current
