"""Checkpoints: a ``state_dict`` plus the JAX package's JSON model spec.

A checkpoint at ``<dir>/<name>`` is

    <dir>/<name>.pt      the model's ``state_dict`` (torch.save)
    <dir>/<name>.json    {"extra": {...}, "config": BranchyConfig as a dict}

The sidecar has the same schema as the JAX package's
(``ee_semantic_segmentation_tpu/train/checkpoint.py``), so any process can
rebuild the model from the JSON.  Only the eval side is ported: saving a
model and loading it for evaluation.  Converting an Orbax checkpoint of the
JAX package is a ROADMAP.md item.
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


def save_checkpoint(directory: str, name: str, model: torch.nn.Module,
                    config: BranchyConfig | None = None, extra: dict | None = None) -> str:
    """Save ``model.state_dict()`` and the spec; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    torch.save(model.state_dict(), path + ".pt")
    meta = {"extra": extra or {}}
    if config is not None:
        meta["config"] = dataclasses.asdict(config)
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=2, default=str)
    return path


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
