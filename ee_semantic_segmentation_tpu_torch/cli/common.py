"""Shared CLI plumbing: device choice, the data-parallel mesh, checkpoint
loading, the eval forward, dataset resolution, CSV append.

Port of ``ee_semantic_segmentation_tpu/cli/common.py``.  A "model" is a
checkpoint path whose ``<path>.json`` sidecar holds the BranchyConfig
(``train/checkpoint.py``).  Under ``torchrun`` every rank loads the model
onto its own GPU and runs its shard (:func:`resolve_device_and_mesh`);
only rank 0 appends CSV rows.
"""

from __future__ import annotations

import csv
import math
import os

import torch

from ee_semantic_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_multihost,
    is_primary,
    launched,
)
from ee_semantic_segmentation_tpu_torch.train.checkpoint import load_model  # noqa: F401


def add_device_flag(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the GPU (default) or, when asked, the CPU")


def resolve_device(name: str) -> torch.device:
    """``--device`` value -> torch.device; CUDA that is absent raises
    instead of silently running on the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass --device cpu to run on the CPU")
    return torch.device(name)


def auto_mesh(device: torch.device):
    """The data-parallel mesh when a launcher (``torchrun``) started this
    process, at any world size, so a one-process launch runs the
    data-parallel path and its collectives; else None, the plain path.
    NCCL on ``cuda``, gloo on ``cpu``."""
    return initialize_multihost(device=device.type)


def resolve_device_and_mesh(name: str):
    """``--device`` value -> (device, mesh): under a launcher the device is
    this rank's GPU ``cuda:LOCAL_RANK`` (the CPU with ``--device cpu``)."""
    device = resolve_device(name)
    mesh = auto_mesh(device)
    return (device if mesh is None else mesh.device), mesh


def forward_fn(model):
    """Eval forward: images (N, H, W, 3), numpy or a tensor -> (E, N, H, W,
    C) float32 logits on the model's device, under ``inference_mode`` with
    the model in eval mode."""
    device = next(model.parameters()).device
    model.eval()

    def f(images):
        with torch.inference_mode():
            return model(torch.as_tensor(images, dtype=torch.float32).to(device))

    return f


def resolve_dims(dimensions) -> int | tuple[int, int]:
    """-D values -> square int or (H, W) tuple (the reference's -D takes two
    values, eval_mIoU.py:46)."""
    dims = [int(d) for d in dimensions]
    if len(dims) == 1 or dims[0] == dims[1]:
        return dims[0]
    return (dims[0], dims[1])


def resolve_test_set(dataset: str, input_dim, data_root: str | None = None):
    """Reference path convention: ``./datasets/<name-prefix>``
    (eval_mIoU.py:78)."""
    from ee_semantic_segmentation_tpu_torch.data.loader import LoadDataset

    data_root = data_root or os.path.join(os.getcwd(), "datasets", dataset.split("_")[0])
    _, _, test = LoadDataset(input_dim, None, None).get_dataset(data_root, dataset)
    return test


def _cell(v, fillna):
    if isinstance(v, float):
        if math.isnan(v):
            return "" if fillna is None else repr(float(fillna))
        return repr(v)
    return v


def append_csv(res: dict, save_at: str, index: str = "net_id", fillna=None):
    """Append the rows of ``res`` (column -> list of values, ``index``
    first) to ``save_at``, writing the header only for a new file.  Same
    layout as the JAX package's pandas ``to_csv``: NaN as an empty field
    unless ``fillna`` is given.  In a data-parallel run only rank 0 writes."""
    if not is_primary():
        return
    cols = [index] + [k for k in res if k != index]
    new = not os.path.exists(save_at)
    with open(save_at, "a", newline="") as fh:
        w = csv.writer(fh)
        if new:
            w.writerow(cols)
        for row in zip(*(res[c] for c in cols)):
            w.writerow([_cell(v, fillna) for v in row])


def net_id_of(path: str) -> str:
    base = path.split("/")[-1]
    return base[:-4] if base.endswith(".pth") else base
