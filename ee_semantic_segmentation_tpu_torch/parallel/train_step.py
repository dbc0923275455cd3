"""The train step: forward over all exits, loss, backward, SGD update.

Port of ``make_train_step`` from
``ee_semantic_segmentation_tpu/parallel/train_step.py``.  The scalar
learning rate is an argument of every step, so the host schedulers change
it per epoch.

With a data-parallel ``mesh`` (``parallel/mesh.py``) every rank passes
the global batch and runs its rows of it, and the step keeps the JAX package's
global-batch semantics, which plain DDP does not: BatchNorm normalises
with the global batch's statistics (``models/resnet.sync_batchnorm``), the
loss is the global batch's on every rank (the loss must be built with the
same mesh), and each rank's gradient is its share of the global loss's
gradient, so the shares are all-reduced with a sum (DDP averages).  Every
rank then takes the same optimizer step from the same gradient, and the
parameters stay bit-identical across the ranks.
"""

from __future__ import annotations

from typing import Callable

import torch

from ee_semantic_segmentation_tpu_torch.models.resnet import sync_batchnorm
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm
from ee_semantic_segmentation_tpu_torch.train.optim import set_lr


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    accum_steps: int = 1, mesh=None):
    """Returns ``step(images, labels, lr) -> loss``.

    ``images`` (B, H, W, 3) and ``labels`` (B, H, W) are tensors on the
    model's device; ``loss_fn(stacked_logits (E, B, H, W, C), labels)`` is a
    scalar.  The returned loss stays on the device (no host sync).  The
    model runs in ``train()`` mode: BatchNorm uses batch statistics and
    advances its running averages, dropout is active.

    ``accum_steps = A > 1`` with B divisible by A splits the batch into A
    micro-batches, rows [i B/A, (i+1) B/A), backpropagates each
    ``loss_i / A`` and takes one optimizer step; the loss is the mean of the
    A micro-batch losses.  As in the JAX package, BatchNorm statistics are
    per micro-batch (the running averages advance A times) and per-batch
    Lovász sorts each micro-batch on its own.  A batch that A does not
    divide takes a single pass.

    ``mesh``: every rank passes the same global batch (on any device), and
    each runs its rows of every micro-batch (``parallel/mesh.shard_batch``)
    on ``mesh.device``; ``loss_fn.mesh`` must be ``mesh``, and the loss is
    called with ``rows``, every rank's row count of the micro-batch.  The
    returned loss is the global loss on every rank.
    """
    A = max(int(accum_steps or 1), 1)
    if mesh is not None:
        if getattr(loss_fn, "mesh", None) is not mesh:
            raise ValueError("a data-parallel train step needs a loss built with the same mesh "
                             "(loss_fn.mesh), or each rank would take its own batch's loss")
        sync_batchnorm(model, mesh)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_of(images, labels):
        if mesh is None:
            return loss_fn(model(images), labels)
        rows = [b - a for a, b in pm.row_blocks(images.shape[0], mesh.world)]
        images, labels = (t.to(mesh.device) for t in pm.shard_batch(mesh, (images, labels)))
        return loss_fn(model(images), labels, rows=rows)

    def step(images: torch.Tensor, labels: torch.Tensor, lr: float) -> torch.Tensor:
        set_lr(optimizer, lr)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        B = images.shape[0]
        if A > 1 and B % A == 0:
            m, total = B // A, None
            for i in range(A):
                loss_i = loss_of(images[i * m:(i + 1) * m], labels[i * m:(i + 1) * m])
                (loss_i / A).backward()
                total = loss_i.detach() if total is None else total + loss_i.detach()
            loss = total / A
        else:
            loss = loss_of(images, labels)
            loss.backward()
            loss = loss.detach()
        if mesh is not None:
            pm.all_reduce_grads(params, mesh)
        optimizer.step()
        return loss

    return step
