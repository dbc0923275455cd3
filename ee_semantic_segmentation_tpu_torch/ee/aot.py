"""Serving artifacts: export once, run anywhere with ``torch.export``.

Port of ``ee_semantic_segmentation_tpu/ee/aot.py``.  The eval forward, or
the whole gated early-exit engine, is traced by ``torch.export`` with the
model's weights in it and saved as one self-contained artifact.  A server
loads and runs it with no model code: only ``torch`` and, for the kernel
head, this package's operator module
``ops/kernels/upsample_argmax.py``, whose import registers the custom
operators (``ee_seg::...``) that the program calls.

Artifact layout (``save_exported``):

* ``<path>.pt2``  — the ``torch.export`` program (``torch.export.save``);
* ``<path>.json`` — a manifest: input and output shapes and dtypes, the
  device the program was traced on, the artifact's bytes, the torch version
  and the caller's metadata (checkpoint, head, batch size, ...).

The program runs on the device it was traced on (its weights live there).
``batch_size=None`` traces a symbolic batch (``torch.export.Dim``): one
artifact serves any batch size.  The gated engine's kernel head
(``pallas_head=True``) takes a fixed batch, as in the JAX package.
"""

from __future__ import annotations

import json
import os

import torch

from ee_semantic_segmentation_tpu_torch.ee.masked import GatedForward


def _example(model, batch_size: int | None):
    """An example image batch on the model's device and in its dtype, and
    the dynamic-shape spec: the batch dimension is symbolic when
    ``batch_size`` is None (traced at 2, served at any size >= 1)."""
    first = next(model.parameters())
    H, W = model.config.img_hw
    x = torch.zeros((batch_size or 2, H, W, 3), dtype=first.dtype, device=first.device)
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("b", min=1)},)
    return x, dynamic


def export_fn(module: torch.nn.Module, example: torch.Tensor, dynamic_shapes=None):
    """``torch.export`` of ``module(example)`` in eval mode without
    autograd; the module's parameters and buffers go into the program."""
    module.eval()
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic_shapes)


def export_eval_forward(model, batch_size: int | None):
    """Export the stacked all-exits eval forward ``images (N, H, W, 3) ->
    (E, N, H, W, C)`` logits with the weights in it (the batched
    evaluators' workload).  ``batch_size=None`` exports a symbolic batch."""
    x, dynamic = _example(model, batch_size)
    return export_fn(model, x, dynamic)


def export_gated(model, batch_size: int | None, *, tau: float, metric: str = "ent",
                 skip: int = 0, n_classes: int = 21, pallas_head: bool = False):
    """Export the masked gated early-exit engine ``images -> (labels (N, H,
    W) int32, exit_idx (N,) int32)`` with the gate policy and the weights in
    it (``ee/masked.GatedForward``: each stage under ``torch.cond``).  With
    ``pallas_head`` the entropy gate and the final head are kernels B and C
    (custom operators in the program).  ``batch_size=None`` exports a
    symbolic batch, which the kernel head does not take, as in the JAX
    package."""
    if batch_size is None and pallas_head:
        raise ValueError("symbolic batch (batch_size=None) is incompatible with "
                         "pallas_head=True: the kernel head is exported at a fixed batch")
    module = GatedForward(model, tau=tau, n_classes=n_classes, skip=skip, pool="none",
                          pool_size=1, pallas_head=pallas_head, metric=metric)
    x, dynamic = _example(model, batch_size)
    return export_fn(module, x, dynamic)


def _avals(ep, names):
    """Shape (ints, or the symbol's name) and dtype of the program's user
    inputs or outputs ``names``."""
    nodes = {n.name: n for n in ep.graph.nodes}
    out = []
    for name in names:
        val = nodes[name].meta["val"]
        out.append({"shape": [d if isinstance(d, int) else str(d) for d in val.shape],
                    "dtype": str(val.dtype).removeprefix("torch.")})
    return out


def save_exported(ep, path: str, manifest: dict | None = None) -> str:
    """Save an ExportedProgram to ``<path>.pt2`` + ``<path>.json``; returns
    the ``.pt2`` path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.export.save(ep, path + ".pt2")
    sig = ep.graph_signature
    device = next((str(t.device) for t in ep.state_dict.values()), "cpu")
    man = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "device": device,
        "in_avals": _avals(ep, sig.user_inputs),
        "out_avals": _avals(ep, sig.user_outputs),
        "bytes": os.path.getsize(path + ".pt2"),
    }
    man.update(manifest or {})
    with open(path + ".json", "w") as fh:
        json.dump(man, fh, indent=1)
    return path + ".pt2"


def load_exported(path: str):
    """Load ``<path>.pt2`` back into an ExportedProgram; run it with
    ``load_exported(path).module()(images)``.  A program with the kernel
    head needs ``ops/kernels/upsample_argmax`` imported first."""
    if not path.endswith(".pt2"):
        path = path + ".pt2"
    if not os.path.exists(path):
        raise FileNotFoundError(f"no exported artifact at {path}")
    return torch.export.load(path)


def manifest_for(path: str) -> dict:
    base = path[: -len(".pt2")] if path.endswith(".pt2") else path
    with open(base + ".json") as fh:
        return json.load(fh)
