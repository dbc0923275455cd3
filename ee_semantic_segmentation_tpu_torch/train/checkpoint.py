"""Checkpoints: a ``state_dict``, the optimizer state, and the JAX package's
JSON model spec.

A checkpoint at ``<dir>/<name>`` is

    <dir>/<name>.pt      the model's ``state_dict`` (torch.save): parameters
                         and BatchNorm running statistics
    <dir>/<name>.opt.pt  {"optimizer": optimizer.state_dict(), "step": int},
                         written by training only
    <dir>/<name>.json    {"extra": {...}, "config": BranchyConfig as a dict}

The sidecar has the same schema as the JAX package's
(``ee_semantic_segmentation_tpu/train/checkpoint.py``), so any process can
rebuild the model from the JSON, and the eval CLIs load a training
checkpoint through ``.pt`` and ``.json`` alone.  Converting an Orbax
checkpoint of the JAX package is a ROADMAP.md item.

In a data-parallel run (``mesh``) every rank calls :func:`save_checkpoint`:
rank 0 writes, and every rank waits at a barrier, so that a load that
follows reads the whole checkpoint on every rank.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import (
    BranchyConfig,
    BranchyDeepLabV3,
)
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm


COMPONENTS = ("params", "batch_stats", "opt_state")


def save_checkpoint(directory: str, name: str, model: torch.nn.Module,
                    config: BranchyConfig | None = None, extra: dict | None = None,
                    optimizer: torch.optim.Optimizer | None = None,
                    step: int | None = None, mesh=None) -> str:
    """Save ``model.state_dict()``, the optimizer state and step when an
    optimizer is given, and the spec; returns the checkpoint path.  With a
    ``mesh`` rank 0 writes and every rank returns after the barrier."""
    path = os.path.join(directory, name)
    if mesh is None or mesh.primary:
        _write(path, model, config, extra, optimizer, step)
    if mesh is not None:
        pm.barrier(mesh)
    return path


def _write(path, model, config, extra, optimizer, step) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path + ".pt")
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(), "step": int(step or 0)},
                   path + ".opt.pt")
    meta = {"extra": extra or {}}
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=2, default=str)


def load_config(path: str) -> BranchyConfig | None:
    if not os.path.exists(path + ".json"):
        return None
    with open(path + ".json") as fh:
        meta = json.load(fh)
    cfg = meta.get("config")
    if cfg is None:
        return None
    cfg["segment_ends"] = tuple(cfg["segment_ends"])
    cfg["branch_channels"] = tuple(cfg["branch_channels"])
    if isinstance(cfg.get("img_dim"), list):  # non-square (H, W) round-trips as list
        cfg["img_dim"] = tuple(cfg["img_dim"])
    return BranchyConfig(**cfg)


def load_model(path: str, device) -> BranchyDeepLabV3:
    """Checkpoint path -> model on ``device``, channels-last, in eval mode.
    Requires the ``.json`` spec sidecar."""
    cfg = load_config(path)
    if cfg is None:
        raise FileNotFoundError(
            f"no model spec at {path}.json — checkpoints are saved with a JSON "
            "config sidecar")
    with torch.device("meta"):  # skip the random init the weights replace
        model = BranchyDeepLabV3(cfg)
    state = torch.load(path + ".pt", map_location=device, weights_only=True)
    model.load_state_dict(state, assign=True)
    return model.to(memory_format=torch.channels_last).eval()


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    components: tuple[str, ...] | None = None) -> dict:
    """Restore a checkpoint into ``model`` (and ``optimizer``) in place;
    returns the sidecar's ``extra`` dict.

    ``components`` restricts what is restored, with the JAX package's
    names: "params" (the model's parameters), "batch_stats" (its BatchNorm
    buffers) and "opt_state" (``.opt.pt``, into ``optimizer``; the step
    saved beside it is a record only).  None restores the model, and the
    optimizer state too when an optimizer is given and the checkpoint has
    one.
    """
    if components is None:
        components = ("params", "batch_stats")
        if optimizer is not None and os.path.exists(path + ".opt.pt"):
            components += ("opt_state",)
    unknown = set(components) - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown checkpoint components {sorted(unknown)}; known: {COMPONENTS}")
    device = next(model.parameters()).device
    state = torch.load(path + ".pt", map_location=device, weights_only=True)
    params = {n for n, _ in model.named_parameters()}
    keep = {k: v for k, v in state.items()
            if ("params" if k in params else "batch_stats") in components}
    missing = [k for k in model.state_dict()
               if ("params" if k in params else "batch_stats") in components and k not in keep]
    if missing:
        raise KeyError(f"{path}.pt lacks {missing}")
    model.load_state_dict(keep, strict=False)
    if "opt_state" in components:
        if optimizer is None:
            raise ValueError("restoring opt_state needs an optimizer")
        opt = torch.load(path + ".opt.pt", map_location=device, weights_only=True)
        optimizer.load_state_dict(opt["optimizer"])
    extra = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as fh:
            extra = json.load(fh).get("extra", {})
    return extra
