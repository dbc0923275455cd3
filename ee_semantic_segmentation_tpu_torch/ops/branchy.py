"""Multi-exit Lovász-Softmax (the training loss of ``main_bradeepv3``).

Port of ``LovaszSoftmax`` from ``ee_semantic_segmentation_tpu/ops/branchy.py``
(branchy_seg_losses.py:133-159): the sum of per-exit Lovász losses over the
``(E, N, H, W, C)`` stacked logits, or their dot with
``linspace(0, 1, n_exits + 1)[1:]`` when ``prev_out`` is set.  All exits go
through one call of ``ops/lovasz._lovasz_exits``, so a step sorts once
forward and once backward (with ``hist_bins``: one histogram forward, one
table lookup backward).  The other multi-exit losses of that module are a
ROADMAP.md item.

With a data-parallel ``mesh`` each exit's loss is the global batch's
(``ops/lovasz.py``), equal on every rank, so the sum or the weighted dot
over exits is the global loss as it stands; only the ``exact_fallback``
census is all-reduced, so that every rank takes the same branch.
"""

from __future__ import annotations

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ops.losses import _squeeze_target
from ee_semantic_segmentation_tpu_torch.ops.lovasz import (
    _class_counts,
    _lovasz_exits,
    present_class_counts,
)
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm


class LovaszSoftmax:
    """Multi-exit Lovász (branchy_seg_losses.py:133-159).

    ``max_present``: score only the K most frequent present classes per
    image (``per_image``) or batch; exact when there are at most K.  With
    ``exact_fallback`` it is exact always: when some image (or the batch)
    has more than K present classes the step takes the all-class loss.  The
    JAX package decides that with a ``lax.cond`` inside the compiled step;
    here it is a Python ``if`` on one count read to the host per step.
    ``hist_bins``: the sort-free histogram approximation with this many
    error buckets (``ops/lovasz.py``); None is the exact sorted loss.
    ``mesh``: a ``parallel/mesh.DataMesh`` whose ranks each pass their rows
    of the global batch, with ``rows``, every rank's row count, in rank
    order (the train step's); every rank gets the global batch's loss.
    """

    def __init__(self, classes="present", per_image=False, ignore=None, n_branches=0,
                 prev_out=False, max_present=None, exact_fallback=False, hist_bins=None,
                 mesh=None):
        self.classes = classes
        self.per_image = per_image
        self.ignore = ignore
        self.n = n_branches + 1
        self.prev_out = prev_out
        self.max_present = max_present
        self.hist_bins = hist_bins
        self.exact_fallback = exact_fallback
        self.mesh = mesh

    def update_n(self, n):
        self.n = n + 1

    @property
    def weights(self) -> torch.Tensor:
        # float32, as the JAX package's constants, whatever the loss's dtype
        if self.prev_out:
            return torch.tensor(np.linspace(0.0, 1.0, self.n + 1)[1:], dtype=torch.float32)
        return torch.ones(self.n, dtype=torch.float32)

    def _loss_with(self, y_pred, targets, max_present, rows):
        per_exit = _lovasz_exits(
            y_pred[: self.n], targets, classes=self.classes, per_image=self.per_image,
            ignore=self.ignore, max_present=max_present, hist_bins=self.hist_bins,
            mesh=self.mesh, rows=rows)
        if self.prev_out:
            return torch.dot(self.weights.to(per_exit), per_exit)
        return per_exit.sum()

    def __call__(self, y_pred, targets, rows=None):
        targets = _squeeze_target(targets)
        C = y_pred.shape[-1]
        compact = (self.classes == "present" and self.max_present is not None
                   and 0 < self.max_present < C)
        if not (compact and self.exact_fallback):
            return self._loss_with(y_pred, targets, self.max_present, rows)
        # present-class census, shared by all exits: one decision per step
        flat = targets.reshape(targets.shape[0], -1)
        valid = (torch.ones_like(flat, dtype=torch.bool) if self.ignore is None
                 else flat != self.ignore)
        if not self.per_image:
            flat, valid = flat.reshape(1, -1), valid.reshape(1, -1)
        if self.mesh is None:
            n_present = int(present_class_counts(flat, valid, C).max())
        elif self.per_image:  # the most of any image of any rank
            n_img = present_class_counts(flat, valid, C)
            top = n_img.max() if n_img.numel() else n_img.new_zeros(())
            n_present = int(pm.all_reduce(top.reshape(1), self.mesh, "max"))
        else:  # the classes of the global batch
            counts = pm.all_reduce(_class_counts(flat, valid, C), self.mesh)
            n_present = int((counts > 0).sum())
        return self._loss_with(y_pred, targets,
                               self.max_present if n_present <= self.max_present else None, rows)
