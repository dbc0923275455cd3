"""The train step: forward over all exits, loss, backward, SGD update.

Port of ``make_train_step`` from
``ee_semantic_segmentation_tpu/parallel/train_step.py`` on one device (the
JAX package's mesh sharding is ROADMAP.md queue A item 6).  The scalar
learning rate is an argument of every step, so the host schedulers change
it per epoch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ee_semantic_segmentation_tpu_torch.train.optim import set_lr


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    accum_steps: int = 1):
    """Returns ``step(images, labels, lr) -> loss``.

    ``images`` (B, H, W, 3) and ``labels`` (B, H, W) are tensors on the
    model's device; ``loss_fn(stacked_logits (E, B, H, W, C), labels)`` is a
    scalar.  The returned loss stays on the device (no host sync).  The
    model runs in ``train()`` mode: BatchNorm uses batch statistics and
    advances its running averages, dropout is active.

    ``accum_steps = A > 1`` with B divisible by A splits the batch into A
    micro-batches, backpropagates each ``loss_i / A`` and takes one
    optimizer step; the loss is the mean of the A micro-batch losses.  As in
    the JAX package, BatchNorm statistics are per micro-batch (the running
    averages advance A times) and per-batch Lovász sorts each micro-batch on
    its own.  A batch that A does not divide takes a single pass.
    """
    A = max(int(accum_steps or 1), 1)

    def step(images: torch.Tensor, labels: torch.Tensor, lr: float) -> torch.Tensor:
        set_lr(optimizer, lr)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if A > 1 and images.shape[0] % A == 0:
            total = None
            for im, lb in zip(images.chunk(A), labels.chunk(A)):
                loss_i = loss_fn(model(im), lb)
                (loss_i / A).backward()
                total = loss_i.detach() if total is None else total + loss_i.detach()
            loss = total / A
        else:
            loss = loss_fn(model(images), labels)
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        return loss

    return step
