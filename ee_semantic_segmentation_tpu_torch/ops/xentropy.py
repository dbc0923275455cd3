"""Pixelwise cross-entropy with ignore_index, single- and multi-exit.

Port of ``ee_semantic_segmentation_tpu/ops/xentropy.py``
(my_pixelwise_xentropy.py): the training loss of ``main_bradeepv3_ce``.
Ignored pixels are masked, and 'mean' divides by the number of
non-ignored pixels, as ``torch.nn.CrossEntropyLoss(ignore_index=...)``
does; unlike it, a label outside [0, C) that is not ``ignore_index`` is
clipped into range (the JAX package's behaviour) instead of raising.

Layout: logits (N, H, W, C) (or any (..., C)), integer targets of the
leading shape; multi-exit logits (E, N, H, W, C).  Runs no kernel.

With a data-parallel ``mesh`` each rank passes its rows of the global
batch: 'sum' is the sum over every rank's pixels and 'mean' divides it by
the global count of valid pixels, as the JAX package's 'mean' over a
sharded batch does; every rank gets that global value, and its gradient
flows to this rank's pixels (``parallel/mesh.global_sum``).
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.losses import _squeeze_target, select_class
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -100,
                  reduction: str | None = "mean", mesh=None) -> torch.Tensor:
    """'mean' over non-ignored pixels, 'sum', or None for the per-pixel map
    with ignored pixels at 0 (this rank's pixels, with a ``mesh``)."""
    targets = targets.to(torch.int32)
    valid = targets != ignore_index
    safe_t = targets.clamp(0, logits.shape[-1] - 1)
    acc = torch.promote_types(logits.dtype, torch.float32)  # >= f32; keeps f64
    log_probs = torch.log_softmax(logits.to(acc), dim=-1)
    nll = torch.where(valid, -select_class(log_probs, safe_t), 0.0)
    if reduction == "mean":
        n_valid = valid.sum().to(acc)
        if mesh is not None:
            n_valid = pm.all_reduce(n_valid.reshape(1), mesh)[0]
        return pm.global_sum(nll.sum(), mesh) / n_valid.clamp_min(1.0)
    if reduction == "sum":
        return pm.global_sum(nll.sum(), mesh)
    return nll


class BrXEntropyLoss:
    """Multi-exit CE (my_pixelwise_xentropy.py:19-46): per-exit scalar CE
    (each with the inner ``reduction``), optional per-exit weights, then
    ``b_reduction`` in {'sum', 'mean', None} across exits.  ``n_exits == 0``
    is plain single-exit CE.  ``mesh``: each exit's CE is the global
    batch's, so the weights and the reduction across exits act on global
    values."""

    def __init__(self, reduction="mean", ignore_index=-100, b_reduction="mean", n_exits=0,
                 weights=None, mesh=None):
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.b_reduction = b_reduction
        self.n_exits = n_exits
        self.mesh = mesh
        if weights and n_exits and len(weights) == n_exits:
            # float32, as the JAX package's constants
            self.weights = torch.tensor(weights, dtype=torch.float32)
        else:
            self.weights = None

    def update_n(self, n):
        """Renegotiated exit count (n is the branch count, exits = n + 1)."""
        self.n_exits = n + 1

    def __call__(self, y_pred, targets, rows=None):
        """``rows``: every rank's row count, which the data-parallel train
        step passes to its loss; CE needs none (it all-reduces its count of
        valid pixels)."""
        targets = _squeeze_target(targets)
        if not self.n_exits:
            return cross_entropy(y_pred, targets, self.ignore_index, self.reduction, self.mesh)
        assert self.n_exits <= y_pred.shape[0]
        losses = torch.stack([cross_entropy(p, targets, self.ignore_index, self.reduction,
                                            self.mesh)
                              for p in y_pred[: self.n_exits]])
        if self.weights is not None:
            losses = losses * self.weights.to(device=losses.device).view(
                (-1,) + (1,) * (losses.ndim - 1))
        if self.b_reduction == "sum":
            return losses.sum()
        if self.b_reduction == "mean":
            return losses.mean()
        return losses
