"""Batched full-forward evaluators: per-exit mIoU and the entropy- and
similarity-gated policies.

Port of the serving half of ``ee_semantic_segmentation_tpu/ee/batch_eval.py``:

* ONE forward per batch computes all exits;
* the gate (an exit's entropy, or the similarity of consecutive exits'
  label maps) is computed for all exits at once, and the exit choice is the
  first exit whose gate fires, else the final head;
* per-exit confusion counts are reduced on the device and only (E, 3, C)
  tensors (or, per image, (N,) scores) come back to the host per batch.

The ``*_fused`` evaluators take the model.  ``mIoU_evaluator`` and
``br_evaluator_entropy`` take a forward function instead (images ->
(E, N, H, W, C) logits, e.g. ``cli/common.forward_fn``), as the JAX
package's do.

Two heads compute the label maps or counts.  The plain head runs the full
forward (``F.interpolate`` upsample), argmax and a bincount.  The kernel
head runs ``lowres_logits`` and hands each exit's low-res logits to the
fused CUDA upsample kernels (``ops/kernels/upsample_argmax.py``), so no
(N, H, W, C) upsampled tensor exists.  On CPU tensors the kernel wrappers
take their plain versions.

Batches carry a ``count`` of valid rows (the loader pads the last batch);
padded rows are masked out of every count.  Everything runs under
``torch.inference_mode()`` with the model in ``eval()``.  The counts of an
evaluation are summed on the device and read once at its end.

``mesh`` (a ``parallel/mesh.DataMesh``) is the counterpart of the JAX
package's ``_pad_to_devices`` and ``shard_map`` steps: every rank reads
the same host batch, pads it to a multiple of the world size with repeats
of its last row, takes its block of rows and rebases ``count`` to its
block (``parallel/mesh.shard_batch(pad=True)``); each rank runs the whole
step on its block, and
the integer counts of the evaluation are all-reduced once at its end, so
they equal the one-process counts bit for bit.  The per-image scores of
``image_level`` are gathered in global image order.
"""

from __future__ import annotations

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import (
    SIM_GREATER,
    batched_norm_entropy,
    batched_similarity,
)
from ee_semantic_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_confusion,
    upsample_entropy_argmax,
)
from ee_semantic_segmentation_tpu_torch.ops.metrics import (
    _img_miou_one,
    confusion_counts,
    confusion_update,
    img_mIoU,
    mIoU,
)
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(images, labels, device):
    return (torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device),
            torch.from_numpy(np.ascontiguousarray(labels, np.int32)).to(device))


def _rank_batch(batch, mesh):
    """(images, labels, count) of a host batch, or with a mesh of this
    rank's padded block of it."""
    if mesh is not None:
        batch = pm.shard_batch(mesh, batch, pad=True)
    images = batch["image"]
    return images, batch["label"], int(batch.get("count", len(images)))


def _sum_counts(acc, *parts):
    """Add one batch's count tensors to the running int64 sums ``acc``
    (None before the first batch)."""
    parts = [p.long() for p in parts]
    return parts if acc is None else [a + p for a, p in zip(acc, parts)]


def _reduced_counts(acc, mesh):
    """The sums as float64 numpy arrays, summed over the ranks with a mesh
    (one all-reduce of every sum)."""
    if mesh is not None:
        flat = pm.all_reduce(torch.cat([a.reshape(-1) for a in acc]), mesh)
        acc = [v.view_as(a) for v, a in zip(flat.split([a.numel() for a in acc]), acc)]
    return [a.double().cpu().numpy() for a in acc]


def make_fused_miou_step_fn(model, num_classes: int):
    """Plain head: ``step(images, labels, count) -> (E, 3, C)`` counts from
    the multi-exit forward, argmax and a bincount over rows < count."""

    def step(images, labels, count):
        preds = model(images)[:, :count].argmax(dim=-1)  # (E, count, H, W)
        return torch.stack([confusion_update(p, labels[:count], num_classes) for p in preds])

    return step


def make_kernel_miou_step_fn(model, num_classes: int):
    """Kernel head, the counterpart of the JAX ``make_pallas_miou_step_fn``:
    the same ``step(images, labels, count) -> (E, 3, C)``, but each exit's
    upsample + argmax + confusion counting is one launch of the fused CUDA
    kernel (``upsample_argmax_confusion``) on its low-res logits — neither
    the upsampled logits nor the argmax maps are written to device memory."""

    def step(images, labels, count):
        out_hw = tuple(images.shape[1:3])
        return torch.stack([
            upsample_argmax_confusion(l, labels, count, out_hw)
            for l in model.lowres_logits(images)
        ])

    return step


def _miou_result(accs, acc, mesh):
    if acc is not None:
        (conf,) = _reduced_counts(acc, mesh)
        for i, a in enumerate(accs):
            a.accumulator += conf[i]
    res = {f"b{i + 1}_mIoU": accs[i].compute() for i in range(len(accs) - 1)}
    res["mIoU"] = accs[-1].compute()
    return res


def mIoU_evaluator_fused(model, n_exits, n_classes, loader, *, empty_class="nan", step=None,
                         mesh=None):
    """Per-exit dataset mIoU (eval_mIoU.py:15-40 equivalent).

    ``step``: a :func:`make_fused_miou_step_fn` or
    :func:`make_kernel_miou_step_fn` result; the plain head by default.
    Returns ``{'b1_mIoU': ..., ..., 'mIoU': ...}``; ``empty_class`` is the
    policy for classes absent from both prediction and truth ('nan', the
    reference's; 'one'; 'skip').  ``mesh``: each rank evaluates its block
    of every batch (module docstring).
    """
    step = step or make_fused_miou_step_fn(model, n_classes)
    device = _device_of(model)
    model.eval()
    accs = [mIoU(n_classes, empty_class=empty_class) for _ in range(n_exits)]
    acc = None
    with torch.inference_mode():
        for batch in loader:
            images, labels, count = _rank_batch(batch, mesh)
            images, labels = _to_device(images, labels, device)
            acc = _sum_counts(acc, step(images, labels, count))
    return _miou_result(accs, acc, mesh)


def mIoU_evaluator(forward_fn, n_exits, n_classes, loader, *, empty_class="nan", mesh=None):
    """Per-exit dataset mIoU (eval_mIoU.py:15-40 equivalent) through
    ``forward_fn(images (N, H, W, 3)) -> (E, N, H, W, C)`` logits.  Returns
    ``{'b1_mIoU': ..., ..., 'mIoU': ...}``; ``empty_class`` and ``mesh`` as
    in :func:`mIoU_evaluator_fused`."""
    accs = [mIoU(n_classes, empty_class=empty_class) for _ in range(n_exits)]
    acc = None
    with torch.inference_mode():
        for batch in loader:
            images, labels, count = _rank_batch(batch, mesh)
            out = forward_fn(images)
            labels = torch.as_tensor(labels[:count]).to(out.device)
            acc = _sum_counts(acc, torch.stack([confusion_update(o[:count], labels, n_classes)
                                                for o in out]))
    return _miou_result(accs, acc, mesh)


def _finalize_gated(res_accs, out_counts, n_branches, tau, extra):
    res = {}
    for i in range(n_branches):
        res[f"b{i + 1}_mIoU"] = res_accs[i].compute()
        res[f"b{i + 1}_count"] = int(out_counts[i])
    res["mIoU_out"] = res_accs[-2].compute()
    res["count_out"] = int(out_counts[-2])
    res["mIoU_gl"] = res_accs[-1].compute()
    res["out_gl"] = int(out_counts[-1])
    res["t"] = tau
    res.update(extra)
    return res


def _bucketed_confusion_masked(preds, labels, exit_idx, valid, num_classes: int):
    """preds (E, N, H, W) label maps, labels (N, H, W), exit_idx (N,) in
    [0, E), valid (N,) bool -> ((E, 3, C) counts of each exit over the valid
    images routed to it, (3, C) counts of the chosen maps over the valid
    images)."""
    E, N = preds.shape[:2]

    def masked_sum(pred, mask):
        tp, fp, fn = confusion_counts(pred, labels, num_classes)  # (N, C)
        m = mask.long()[:, None]
        return torch.stack([(tp * m).sum(0), (fp * m).sum(0), (fn * m).sum(0)])

    bucketed = torch.stack([masked_sum(preds[e], (exit_idx == e) & valid) for e in range(E)])
    chosen = preds[exit_idx, torch.arange(N, device=preds.device)]
    return bucketed, masked_sum(chosen, valid)


def _exit_histogram(exit_idx, valid, n_exits: int):
    """(E,) number of valid images routed to each exit."""
    e = torch.arange(n_exits, device=exit_idx.device)
    return ((exit_idx[None, :] == e[:, None]) & valid[None, :]).sum(dim=1)


def _gated_result(acc, n_images, mesh, n_branches, tau, n_classes, extra):
    """The gated policy's result from the evaluation's sums ``acc``
    ((E, 3, C) per-exit counts, (3, C) chosen-map counts, (E,) exit
    histogram) and its image count."""
    n_exits = n_branches + 1
    accs = [mIoU(n_classes) for _ in range(n_exits + 1)]
    counts = np.zeros(n_exits + 1, np.int64)
    if acc is not None:
        bucketed, chosen, exits = _reduced_counts(acc, mesh)
        for e in range(n_exits):
            accs[e].accumulator += bucketed[e]
        accs[-1].accumulator += chosen
        counts[:-1] += exits.astype(np.int64)
    counts[-1] = n_images
    return _finalize_gated(accs, counts, n_branches, tau, extra)


def _first_firing(fires, skip: int, n_branches: int):
    """(n_branches, N) gate results -> (N,) exit: the first branch i >= skip
    whose gate fires, else ``n_branches`` (the final head)."""
    fires = fires.clone()
    fires[:skip] = False
    first = fires.to(torch.uint8).argmax(dim=0)  # first firing exit
    return torch.where(fires.any(dim=0), first, n_branches)


def br_evaluator_entropy_fused(
    model, n_exits, n_classes, loader, tau, *, metric="ent", size=1, skip=0,
    pallas_head: bool = False, mesh=None,
):
    """Entropy-gated policy simulation (eval_br_ent.py:38-84 equivalent).

    Exit at the first branch i >= skip whose mean normalized entropy < tau;
    otherwise take the final head.  Accumulators: per-exit mIoU over the
    images that exited there, 'out' for the final head, 'gl' for the
    policy's chosen outputs overall, plus exit counts.

    ``pallas_head=True`` (entropy gate without pooling only, as in the JAX
    package) computes each exit's label map AND gate entropy with the fused
    CUDA kernel ``upsample_entropy_argmax`` from the low-res logits.
    ``mesh``: each rank evaluates its block of every batch (module
    docstring).
    """
    n_branches = n_exits - 1
    pool_mode = {"ent": "none", "max": "max", "min": "min"}[metric.lower()]
    use_kernel = pallas_head and pool_mode == "none"
    device = _device_of(model)
    model.eval()

    def body(images, labels, count):
        N = images.shape[0]
        if use_kernel:
            out_hw = tuple(images.shape[1:3])
            per_exit = [upsample_entropy_argmax(l, out_hw) for l in model.lowres_logits(images)]
            preds = torch.stack([p for p, _ in per_exit])  # (E, N, H, W)
            ent = [e for _, e in per_exit[:-1]]
        else:
            stacked = model(images)
            ent = list(batched_norm_entropy(stacked[:-1], n_classes, pool_mode, size))
            preds = stacked.argmax(dim=-1)
        exit_idx = torch.full((N,), n_branches, dtype=torch.long, device=images.device)
        if n_branches:
            exit_idx = _first_firing(torch.stack(ent) < tau, skip, n_branches)
        valid = torch.arange(N, device=images.device) < count
        bucketed, chosen_conf = _bucketed_confusion_masked(
            preds, labels, exit_idx, valid, num_classes=n_classes)
        return bucketed, chosen_conf, _exit_histogram(exit_idx, valid, n_exits)

    acc, n_images = None, 0
    with torch.inference_mode():
        for batch in loader:
            n_images += int(batch.get("count", len(batch["image"])))
            images, labels, count = _rank_batch(batch, mesh)
            images, labels = _to_device(images, labels, device)
            acc = _sum_counts(acc, *body(images, labels, count))
    return _gated_result(acc, n_images, mesh, n_branches, tau, n_classes,
                         {"pool": metric, "pool_size": size})


def br_evaluator_entropy(
    forward_fn, n_exits, n_classes, loader, tau, *, metric="ent", size=1, skip=0, mesh=None
):
    """The entropy-gated policy of :func:`br_evaluator_entropy_fused` through
    ``forward_fn(images (N, H, W, 3)) -> (E, N, H, W, C)`` logits (the plain
    head): the same accumulators, result and ``mesh``."""
    n_branches = n_exits - 1
    pool_mode = {"ent": "none", "max": "max", "min": "min"}[metric.lower()]
    acc, n_images = None, 0
    with torch.inference_mode():
        for batch in loader:
            n_images += int(batch.get("count", len(batch["image"])))
            images, labels, count = _rank_batch(batch, mesh)
            out = forward_fn(images)
            stacked = out[:, :count]
            labels = torch.as_tensor(labels[:count]).to(out.device)
            ent = batched_norm_entropy(stacked[:-1], n_classes, pool_mode, size)  # (E-1, N)
            exit_idx = _first_firing(ent < tau, skip, n_branches)
            valid = torch.ones(count, dtype=torch.bool, device=out.device)
            bucketed, chosen_conf = _bucketed_confusion_masked(
                stacked.argmax(dim=-1), labels, exit_idx, valid, num_classes=n_classes)
            acc = _sum_counts(acc, bucketed, chosen_conf,
                              _exit_histogram(exit_idx, valid, n_exits))
    return _gated_result(acc, n_images, mesh, n_branches, tau, n_classes,
                         {"pool": metric, "pool_size": size})


def _similarity_exits(preds, metric: str, tau: float, n_classes: int, ignore, skip: int):
    """(E, N, H, W) exit label maps -> (N,) chosen exit: the first gate
    position i in [1 + skip, n_branches) whose maps i - 1 and i are similar
    enough (sim > tau for ssim and nmi, sim < tau otherwise), else the final
    head (eval_br_sim.py:41-48).  With one branch or none there is no pair
    to gate on and every image takes the final head."""
    n_branches, N = preds.shape[0] - 1, preds.shape[1]
    exit_idx = torch.full((N,), n_branches, dtype=torch.long, device=preds.device)
    if n_branches <= 1:
        return exit_idx
    # only the pairs (i - 1, i) with i < n_branches are gates
    sims = batched_similarity(preds[:n_branches], metric, n_classes, ignore)
    fires = (sims > tau) if metric.lower() in SIM_GREATER else (sims < tau)
    fires[:skip] = False  # gate position i = row i - 1; i < 1 + skip never fires
    first = fires.to(torch.uint8).argmax(dim=0) + 1
    return torch.where(fires.any(dim=0), first, exit_idx)


def _exit_maps(model, images, pallas_head: bool):
    """(E, N, H, W) label maps of every exit: kernel C on each exit's low-res
    logits, or the plain head's full forward and argmax."""
    if pallas_head:
        out_hw = tuple(images.shape[1:3])
        return torch.stack([upsample_argmax(l, out_hw) for l in model.lowres_logits(images)])
    return model(images).argmax(dim=-1)


def br_evaluator_similarity_fused(
    model, n_exits, n_classes, loader, metric, tau, *, ignore=(), skip=0,
    pallas_head: bool = False, mesh=None,
):
    """Similarity-gated policy simulation (eval_br_sim.py:16-65 equivalent)
    with confusion-matrix accumulators.

    Exit at the first branch i >= 1 + skip whose label map is similar enough
    to the previous exit's.  The gates read only label maps, so
    ``pallas_head=True`` computes each exit's map with the fused CUDA
    upsample + argmax kernel ``upsample_argmax`` from the low-res logits.
    ``mesh``: each rank evaluates its block of every batch (module
    docstring).
    """
    n_branches = n_exits - 1
    device = _device_of(model)
    model.eval()
    acc, n_images = None, 0
    with torch.inference_mode():
        for batch in loader:
            n_images += int(batch.get("count", len(batch["image"])))
            images, labels, count = _rank_batch(batch, mesh)
            images, labels = _to_device(images, labels, device)
            preds = _exit_maps(model, images, pallas_head)
            exit_idx = _similarity_exits(preds, metric, tau, n_classes, ignore, skip)
            valid = torch.arange(images.shape[0], device=device) < count
            bucketed, chosen_conf = _bucketed_confusion_masked(
                preds, labels, exit_idx, valid, num_classes=n_classes)
            acc = _sum_counts(acc, bucketed, chosen_conf,
                              _exit_histogram(exit_idx, valid, n_exits))
    return _gated_result(acc, n_images, mesh, n_branches, tau, n_classes, {"metric": metric})


def br_evaluator_similarity(
    model, n_exits, n_classes, loader, metric, tau, *, ignore=(), skip=0,
    image_level: bool = False, mesh=None,
):
    """The similarity-gated policy with the plain head;
    ``image_level=True`` mirrors eval_br_images.py: per-image mIoU
    accumulators (``img_mIoU`` over ``n_classes + 1`` classes, the void id
    included) instead of confusion matrices.  Each image's score is that of
    the exit it takes; only (N,) scores and exit indices reach the host.
    ``mesh``: each rank scores its block of every batch, and the scores and
    exits are gathered in global image order before they are added."""
    if not image_level:
        return br_evaluator_similarity_fused(model, n_exits, n_classes, loader, metric, tau,
                                             ignore=ignore, skip=skip, mesh=mesh)
    n_branches = n_exits - 1
    accs = [img_mIoU(num_classes=n_classes + 1) for _ in range(n_exits + 1)]
    counts = np.zeros(n_exits + 1, np.int64)
    device = _device_of(model)
    model.eval()
    with torch.inference_mode():
        for batch in loader:
            n_rows, n_valid = len(batch["image"]), int(batch.get("count", len(batch["image"])))
            images, labels, count = _rank_batch(batch, mesh)
            images, labels = _to_device(images, labels, device)
            preds = _exit_maps(model, images, pallas_head=False)[:, :count]
            exit_idx = _similarity_exits(preds, metric, tau, n_classes, ignore, skip)
            chosen = preds[exit_idx, torch.arange(count, device=device)]
            scores = _img_miou_one(chosen.flatten(1), labels[:count].flatten(1), n_classes + 1)
            if mesh is not None:  # every rank's images, in global order
                sizes = pm.block_counts(n_rows, n_valid, mesh.world, pad=True)
                exit_idx = pm.all_gather_dim(exit_idx, mesh, sizes, dim=0)
                scores = pm.all_gather_dim(scores, mesh, sizes, dim=0)
                count = n_valid
            for e, score in zip(exit_idx.tolist(), scores.tolist()):
                accs[e].add_score(score)
                accs[-1].add_score(score)
                counts[e] += 1
            counts[-1] += count
    return _finalize_gated(accs, counts, n_branches, tau, {"metric": metric})
