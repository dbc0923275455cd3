"""Segmentation metrics: confusion counts, the streaming dataset mIoU, the
per-image mIoU and the PRF metrics.

Port of ``ee_semantic_segmentation_tpu/ops/metrics.py`` (``confusion_counts``,
``confusion_update``, ``mIoU``, ``_img_miou_one``, ``img_mIoU``, and the
reduction-style ``SegMetric``, ``Recall``, ``Precision``, ``F_beta`` and
``Accuracy``).  Semantics are the JAX package's: a void label (outside
``[0, C)``) matches no class, so its pixel counts as FP for the predicted
class only.

The JAX version builds one-hot products; at 512², batch 16 and 3 exits that
tensor is about 1 GB in eager PyTorch.  Here the counts come from ONE
``torch.bincount`` over ``n * K² + pred * K + label`` with ``K = C + 1``
(out-of-range ids folded into bucket ``C``), i.e. a per-sample joint
histogram of (prediction, label).  Counts are exact int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ops.losses import apply_reduction


def _squeeze_target(targets: torch.Tensor) -> torch.Tensor:
    """Accept (N,H,W), (N,H,W,1) or (N,1,H,W)-style targets, return (N,H,W)."""
    if targets.ndim == 4:
        if targets.shape[-1] == 1:
            targets = targets[..., 0]
        elif targets.shape[1] == 1:
            targets = targets[:, 0]
    return targets.long()


def _flatten_pixels(y_pred: torch.Tensor, targets: torch.Tensor):
    """(N, H, W, C) logits and their targets -> predicted and true labels,
    each (N, P)."""
    N = y_pred.shape[0]
    return y_pred.argmax(dim=-1).reshape(N, -1), _squeeze_target(targets).reshape(N, -1)


def confusion_counts(y_pred: torch.Tensor, targets: torch.Tensor,
                     num_classes: int | None = None):
    """Per-sample per-class (TP, FP, FN), each (N, C) int64.

    y_pred: (N, H, W, C) logits (argmax over the last axis) or an already
    argmaxed integer map (N, H, W).
    """
    if y_pred.is_floating_point():
        C = num_classes or y_pred.shape[-1]
        pred = y_pred.argmax(dim=-1)
    else:
        if num_classes is None:
            raise ValueError("num_classes required for label-map input")
        C = num_classes
        pred = _squeeze_target(y_pred)
    N = pred.shape[0]
    K = C + 1
    P = pred.numel() // max(N, 1)  # not -1: a data-parallel rank's block may have no rows
    pred = pred.reshape(N, P).long()
    tgt = _squeeze_target(targets).reshape(N, P)
    pred = torch.where((pred >= 0) & (pred < C), pred, C)
    tgt = torch.where((tgt >= 0) & (tgt < C), tgt, C)
    offset = torch.arange(N, device=pred.device)[:, None] * (K * K)
    joint = torch.bincount((offset + pred * K + tgt).reshape(-1), minlength=N * K * K)
    joint = joint.reshape(N, K, K)  # [n, predicted, true]
    tp = joint[:, :C, :C].diagonal(dim1=1, dim2=2)
    fp = joint[:, :C, :].sum(dim=2) - tp
    fn = joint[:, :, :C].sum(dim=1) - tp
    return tp, fp, fn


def confusion_update(y_pred, targets, num_classes: int) -> torch.Tensor:
    """(3, C) batch-summed confusion counts (int64)."""
    tp, fp, fn = confusion_counts(y_pred, targets, num_classes)
    return torch.stack([tp.sum(0), fp.sum(0), fn.sum(0)])


class mIoU:
    """Streaming dataset-level mIoU (compute_mIoU.py:7-36)."""

    def __init__(self, n_classes: int, empty_class: str = "nan"):
        self.C = n_classes
        self.empty_class = empty_class
        self.reset()

    def reset(self):
        self.accumulator = np.zeros((3, self.C), np.float64)

    def __call__(self, y_pred, targets):
        self.accumulator += confusion_update(y_pred, targets, self.C).cpu().numpy()

    def compute(self) -> float:
        tp = self.accumulator[0]
        den = self.accumulator.sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            ciou = tp / den
        if self.empty_class == "one":
            ciou = np.where(den > 0, ciou, 1.0)
        elif self.empty_class == "skip":
            ciou = ciou[den > 0]
            return float(np.mean(ciou)) if ciou.size else float("nan")
        # 'nan': NaN propagates, matching the reference (compute_mIoU.py:35).
        return float(np.sum(ciou) / self.C)


def _img_miou_one(pred: torch.Tensor, tgt: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., P) predicted and true label maps -> (...,) float32 mean IoU
    over the classes present in each image's truth (compute_mIoU.py:43-57).
    ``num_classes`` must cover the void id (VOC: 22), which the reference's
    ``unique()`` counts as a class; labels outside [0, num_classes) belong
    to no class."""
    lead = pred.shape[:-1]
    K = num_classes + 1  # bucket num_classes takes what is out of range
    pred = pred.reshape(-1, pred.shape[-1]).long()
    tgt = tgt.reshape(pred.shape).long()
    pred = torch.where((pred >= 0) & (pred < num_classes), pred, num_classes)
    tgt = torch.where((tgt >= 0) & (tgt < num_classes), tgt, num_classes)
    offset = torch.arange(pred.shape[0], device=pred.device)[:, None] * (K * K)
    joint = torch.bincount((offset + pred * K + tgt).reshape(-1), minlength=pred.shape[0] * K * K)
    joint = joint.reshape(-1, K, K).to(torch.float32)  # [image, predicted, true]
    inter = joint.diagonal(dim1=1, dim2=2)[:, :num_classes]
    gt = joint.sum(dim=1)[:, :num_classes]
    pr = joint.sum(dim=2)[:, :num_classes]
    union = gt + pr - inter
    present = gt > 0
    iou = torch.where(present, inter / union.clamp_min(1.0), 0.0)
    return (iou.sum(-1) / present.sum(-1).to(torch.float32).clamp_min(1.0)).reshape(lead)


class img_mIoU:
    """Streaming per-image mIoU (compute_mIoU.py:38-63)."""

    def __init__(self, num_classes: int = 22):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def __call__(self, y_pred, target):
        pred = y_pred.argmax(dim=-1) if y_pred.is_floating_point() else _squeeze_target(y_pred)
        tgt = _squeeze_target(target)
        self.total += float(_img_miou_one(pred.reshape(-1), tgt.reshape(-1), self.num_classes))
        self.count += 1

    def add_score(self, value: float, n: int = 1):
        """Fold in already-computed per-image scores (the batched evaluators
        compute ``_img_miou_one`` on the device)."""
        self.total += float(value)
        self.count += n

    def compute(self) -> float:
        return self.total / self.count if self.count > 0 else float("nan")


class SegMetric:
    """Base for reduction-style metrics (seg_metrics.py:8-28) on (N, H, W, C)
    logits.  ``avg``: 'macro' (per-class ratios averaged), 'micro' (counts
    summed over classes first) or anything else (per-class ratios)."""

    def __init__(self, smooth=1e-6, reduction="mean", avg="macro"):
        self.smooth = smooth
        self.reduction = reduction
        self.avg = avg

    def _compute_basics(self, y_pred, targets):
        tp, fp, fn = confusion_counts(y_pred, targets, num_classes=y_pred.shape[-1])
        return tp.float(), fp.float(), fn.float()

    def _compute_loss(self, y_pred, targets):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, y_pred, targets):
        return apply_reduction(self._compute_loss(y_pred, _squeeze_target(targets)), self.reduction)


class Recall(SegMetric):
    def _compute_loss(self, y_pred, targets):
        tp, _, fn = self._compute_basics(y_pred, targets)
        if self.avg == "macro":
            return ((tp + self.smooth) / (tp + fn + self.smooth)).mean(dim=-1)
        if self.avg == "micro":
            tp, fn = tp.sum(-1), fn.sum(-1)
        return (tp + self.smooth) / (tp + fn + self.smooth)


class Precision(SegMetric):
    def _compute_loss(self, y_pred, targets):
        tp, fp, _ = self._compute_basics(y_pred, targets)
        if self.avg == "macro":
            return ((tp + self.smooth) / (tp + fp + self.smooth)).mean(dim=-1)
        if self.avg == "micro":
            tp, fp = tp.sum(-1), fp.sum(-1)
        return (tp + self.smooth) / (tp + fp + self.smooth)


class F_beta(SegMetric):
    def __init__(self, beta=1.0, smooth=1e-6, reduction="mean", avg="macro"):
        super().__init__(smooth, reduction, avg)
        self.beta = beta

    def _compute_loss(self, y_pred, targets):
        tp, fp, fn = self._compute_basics(y_pred, targets)
        b2 = self.beta**2
        if self.avg == "micro":
            tp, fp, fn = tp.sum(-1), fp.sum(-1), fn.sum(-1)
        f = ((1 + b2) * tp + self.smooth) / ((1 + b2) * tp + b2 * fn + fp + self.smooth)
        return f.mean(dim=-1) if self.avg == "macro" else f


class Accuracy(SegMetric):
    def _compute_loss(self, y_pred, targets):
        pred, tgt = _flatten_pixels(y_pred, targets)
        return (pred == tgt).float().mean(dim=1)
