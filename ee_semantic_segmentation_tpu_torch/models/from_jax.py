"""Load a flax ``BranchyDeepLabV3`` variable tree into the port's model.

The JAX package's variables are ``{"params": ..., "batch_stats": ...}``
nested dicts; the caller converts their leaves to numpy first (for example
``jax.tree.map(np.asarray, variables)``), so this module needs no JAX.

Mapping (flax path -> torch name):

* ``block_{i}`` -> ``blocks.{i}``, ``branch_{k}`` -> ``branches.{k}``,
  every other path component unchanged;
* conv ``kernel`` (HWIO) -> ``weight`` (OIHW); conv ``bias`` -> ``bias``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``;
* batch_stats ``mean``/``var`` -> ``running_mean``/``running_var``.

Every parameter and buffer of the port must be filled (BN's
``num_batches_tracked`` aside) and every flax leaf used; anything else
raises, so a naming drift between the two models cannot pass silently.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_LISTS = {"block": "blocks", "branch": "branches"}


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(collection: str, path: tuple) -> str:
    *mods, leaf = path
    mods = [re.sub(r"^(block|branch)_(\d+)$",
                   lambda m: f"{_LISTS[m.group(1)]}.{m.group(2)}", p) for p in mods]
    if (collection, leaf) not in _LEAF:
        raise KeyError(f"unknown flax leaf {collection}/{'/'.join(path)}")
    return ".".join(mods + [_LEAF[(collection, leaf)]])


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    """Copy flax variables (numpy leaves) into ``model`` in place."""
    targets = dict(model.named_parameters())
    targets.update((n, b) for n, b in model.named_buffers()
                   if not n.endswith("num_batches_tracked"))
    unused, filled = [], set()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name = _torch_name(collection, path)
            if name not in targets:
                unused.append(f"{collection}/{'/'.join(path)} (-> {name})")
                continue
            arr = np.asarray(value)
            if arr.ndim == 4:  # conv kernel HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            dst = targets[name]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {arr.shape} does not fit "
                    f"{name} {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if unused or missing:
        raise ValueError(
            f"flax variables do not match the port's model: unused flax leaves "
            f"{unused}, unfilled port tensors {missing}")
