"""Helpers shared by the training losses and the PRF metrics (channels-last).

Port of the helpers of ``ee_semantic_segmentation_tpu/ops/losses.py`` that
the multi-exit Lovász and cross-entropy losses and ``ops/metrics.py`` use.
The single-exit loss classes (Dice, Jaccard, Tversky, Focal) are a
ROADMAP.md item.
"""

from __future__ import annotations

import torch


def _squeeze_target(targets: torch.Tensor) -> torch.Tensor:
    """Accept (N,H,W), (N,H,W,1) or (N,1,H,W)-style targets, return (N,H,W)."""
    if targets.ndim == 4:
        if targets.shape[-1] == 1:
            targets = targets[..., 0]
        elif targets.shape[1] == 1:
            targets = targets[:, 0]
    return targets.to(torch.int32)


def apply_reduction(loss: torch.Tensor, reduction: str | None) -> torch.Tensor:
    """SegLoss.forward reduction contract (new_seg_losses.py:17-32)."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    dims = tuple(range(1, loss.ndim))  # none for a (N,) loss: torch reads () as all
    if reduction == "mean_batchwise":
        return loss.mean(dim=dims) if dims else loss
    if reduction == "sum_batchwise":
        return loss.sum(dim=dims) if dims else loss
    return loss


def select_class(values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``values[..., targets]``, the per-pixel class entry.

    The JAX package writes this as a compare + select + sum because the
    gather's scatter-add gradient was slow on the TPU; on the GPU the
    gather and its scatter-add gradient are ordinary passes, and the values
    are the same.  ``targets`` must already be in ``[0, C)``.
    """
    return torch.gather(values, -1, targets.to(torch.int64)[..., None])[..., 0]
