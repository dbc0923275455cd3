"""SGD with torch semantics and per-group learning rates.

Port of ``ee_semantic_segmentation_tpu/train/optim.py``.  The reference
optimizes with ``optim.SGD(params, lr, momentum=.9, weight_decay=5e-4)`` over
parameter groups (deepv3_funcs.py:74-101): backbone at ``base_lr``, each
branch at ``lr * w_i``, classifier at ``1.1 * lr``, with optional freezing.

Here every group always exists (backbone, ``branch_0`` ..., classifier) and
carries a ``mult``; :func:`set_lr` sets each group's ``lr`` to the
scheduled scalar ``lr * mult``.  A frozen group stays in the optimizer at
multiplier 0: its momentum buffer keeps tracing and its step is zero, as
with the JAX package's optax chain, so the optimizer state matches JAX's
and a checkpoint's optimizer state loads whatever the group settings.
"""

from __future__ import annotations

import numpy as np
import torch


def label_params(name: str) -> str:
    """A parameter's name in the port's model -> its group: 'backbone'
    (``stem.*``, ``blocks.*``), 'branch_<k>' (``branches.<k>.*``) or
    'classifier' (everything else)."""
    top = name.split(".")
    if top[0] in ("stem", "blocks"):
        return "backbone"
    if top[0] == "branches":
        return f"branch_{top[1]}"
    return "classifier"


def branchy_lr_multipliers(
    n_branches: int,
    lr: float,
    base_lr: float | None = None,
    weighted_lr: bool = False,
    freeze_backbone: bool = False,
    freeze_from: int | None = None,
) -> dict[str, float]:
    """Group -> lr multiplier (relative to the scheduled scalar ``lr``),
    as deepv3_funcs.py:74-99:

    * backbone at ``base_lr`` (or frozen),
    * ``weighted_lr``: branches at ``lr * linspace(1, 1.2, n)[:-1]`` and the
      classifier at the last weight; the last branch is never put in a group
      by the reference, so it is frozen,
    * ``freeze_backbone`` + ``freeze_from``: branches >= freeze_from frozen,
    * default: branches at ``lr``, classifier at ``lr * 1.1``.
    """
    base_lr = base_lr if base_lr is not None else lr
    mult = {"backbone": 0.0 if freeze_backbone else base_lr / lr}
    if weighted_lr and n_branches:
        weights = np.linspace(1.0, 1.2, num=n_branches)
        for i in range(n_branches - 1):
            mult[f"branch_{i}"] = float(weights[i])
        mult[f"branch_{n_branches - 1}"] = 0.0
        mult["classifier"] = float(weights[-1])
    else:
        for i in range(n_branches):
            frozen = freeze_backbone and freeze_from is not None and i >= freeze_from
            mult[f"branch_{i}"] = 0.0 if frozen else 1.0
        mult["classifier"] = 1.0 if freeze_backbone else 1.1
    return mult


def make_optimizer(model: torch.nn.Module, multipliers: dict[str, float] | None = None,
                   momentum: float = 0.9, weight_decay: float = 5e-4) -> torch.optim.SGD:
    """``torch.optim.SGD`` (dampening 0, no Nesterov) with one group per
    label, in the order backbone, branches, classifier.  Each group holds
    its ``name`` and ``mult`` (1.0 for a label ``multipliers`` lacks, or
    for all when it is None); its ``lr`` is set by :func:`set_lr`."""
    groups: dict[str, list] = {}
    for name, p in model.named_parameters():
        groups.setdefault(label_params(name), []).append(p)
    multipliers = multipliers or {}
    order = sorted(groups, key=lambda g: (g != "backbone", g == "classifier",
                                          int(g.split("_")[1]) if g.startswith("branch_") else 0))
    return torch.optim.SGD(
        [{"params": groups[g], "name": g, "mult": float(multipliers.get(g, 1.0))} for g in order],
        lr=0.0, momentum=momentum, dampening=0.0, weight_decay=weight_decay, nesterov=False)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's learning rate <- ``lr * mult``."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr) * group["mult"]
