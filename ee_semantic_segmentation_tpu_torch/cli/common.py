"""Shared CLI plumbing: device choice, checkpoint loading, the eval forward,
dataset resolution, CSV append.

Port of ``ee_semantic_segmentation_tpu/cli/common.py`` without the mesh.  A
"model" is a checkpoint path whose ``<path>.json`` sidecar holds the
BranchyConfig (``train/checkpoint.py``).
"""

from __future__ import annotations

import csv
import math
import os

import torch

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
    unless ``fillna`` is given."""
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
