"""Batched full-forward evaluators: per-exit mIoU and the entropy- and
similarity-gated policies.

Port of the serving half of ``ee_semantic_segmentation_tpu/ee/batch_eval.py``:

* ONE forward per batch computes all exits;
* the gate (an exit's entropy, or the similarity of consecutive exits'
  label maps) is computed for all exits at once, and the exit choice is the
  first exit whose gate fires, else the final head;
* per-exit confusion counts are reduced on the device and only (E, 3, C)
  tensors (or, per image, (N,) scores) come back to the host per batch.

Two heads compute the label maps or counts.  The plain head runs the full
forward (``F.interpolate`` upsample), argmax and a bincount.  The kernel
head runs ``lowres_logits`` and hands each exit's low-res logits to the
fused CUDA upsample kernels (``ops/kernels/upsample_argmax.py``), so no
(N, H, W, C) upsampled tensor exists.  On CPU tensors the kernel wrappers
take their plain versions.

Batches carry a ``count`` of valid rows (the loader pads the last batch);
padded rows are masked out of every count.  Everything runs under
``torch.inference_mode()`` with the model in ``eval()``.  The JAX package's
``mesh``/``shard_map`` variants are not ported (multi-GPU is a ROADMAP.md
item).
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


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to_device(batch, device):
    images = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32)).to(device)
    labels = torch.from_numpy(np.ascontiguousarray(batch["label"], np.int32)).to(device)
    return images, labels


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


def mIoU_evaluator_fused(model, n_exits, n_classes, loader, *, empty_class="nan", step=None):
    """Per-exit dataset mIoU (eval_mIoU.py:15-40 equivalent).

    ``step``: a :func:`make_fused_miou_step_fn` or
    :func:`make_kernel_miou_step_fn` result; the plain head by default.
    Returns ``{'b1_mIoU': ..., ..., 'mIoU': ...}``; ``empty_class`` is the
    policy for classes absent from both prediction and truth ('nan', the
    reference's; 'one'; 'skip').
    """
    step = step or make_fused_miou_step_fn(model, n_classes)
    device = _device_of(model)
    model.eval()
    accs = [mIoU(n_classes, empty_class=empty_class) for _ in range(n_exits)]
    with torch.inference_mode():
        for batch in loader:
            count = int(batch.get("count", len(batch["image"])))
            images, labels = _to_device(batch, device)
            conf = step(images, labels, count).double().cpu().numpy()
            for i in range(n_exits):
                accs[i].accumulator += conf[i]
    res = {f"b{i + 1}_mIoU": accs[i].compute() for i in range(n_exits - 1)}
    res["mIoU"] = accs[-1].compute()
    return res


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


def br_evaluator_entropy_fused(
    model, n_exits, n_classes, loader, tau, *, metric="ent", size=1, skip=0,
    pallas_head: bool = False,
):
    """Entropy-gated policy simulation (eval_br_ent.py:38-84 equivalent).

    Exit at the first branch i >= skip whose mean normalized entropy < tau;
    otherwise take the final head.  Accumulators: per-exit mIoU over the
    images that exited there, 'out' for the final head, 'gl' for the
    policy's chosen outputs overall, plus exit counts.

    ``pallas_head=True`` (entropy gate without pooling only, as in the JAX
    package) computes each exit's label map AND gate entropy with the fused
    CUDA kernel ``upsample_entropy_argmax`` from the low-res logits.
    """
    n_branches = n_exits - 1
    accs = [mIoU(n_classes) for _ in range(n_exits + 1)]
    counts = np.zeros(n_exits + 1, np.int64)
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
            fires = torch.stack(ent) < tau  # (E-1, N)
            fires[:skip] = False
            first = fires.to(torch.uint8).argmax(dim=0)  # first firing exit
            exit_idx = torch.where(fires.any(dim=0), first, exit_idx)
        valid = torch.arange(N, device=images.device) < count
        bucketed, chosen_conf = _bucketed_confusion_masked(
            preds, labels, exit_idx, valid, num_classes=n_classes)
        bucket_counts = ((exit_idx[None, :] == torch.arange(n_exits, device=images.device)[:, None])
                         & valid[None, :]).sum(dim=1)
        return bucketed, chosen_conf, bucket_counts

    with torch.inference_mode():
        for batch in loader:
            count = int(batch.get("count", len(batch["image"])))
            images, labels = _to_device(batch, device)
            bucketed, chosen_conf, bucket_counts = body(images, labels, count)
            bucketed = bucketed.double().cpu().numpy()
            for e in range(n_exits):
                accs[e].accumulator += bucketed[e]
            accs[-1].accumulator += chosen_conf.double().cpu().numpy()
            counts[:n_exits] += bucket_counts.cpu().numpy()
            counts[-1] += count

    return _finalize_gated(accs, counts, n_branches, tau, {"pool": metric, "pool_size": size})


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
    pallas_head: bool = False,
):
    """Similarity-gated policy simulation (eval_br_sim.py:16-65 equivalent)
    with confusion-matrix accumulators.

    Exit at the first branch i >= 1 + skip whose label map is similar enough
    to the previous exit's.  The gates read only label maps, so
    ``pallas_head=True`` computes each exit's map with the fused CUDA
    upsample + argmax kernel ``upsample_argmax`` from the low-res logits.
    """
    n_branches = n_exits - 1
    accs = [mIoU(n_classes) for _ in range(n_exits + 1)]
    counts = np.zeros(n_exits + 1, np.int64)
    device = _device_of(model)
    model.eval()
    with torch.inference_mode():
        for batch in loader:
            count = int(batch.get("count", len(batch["image"])))
            images, labels = _to_device(batch, device)
            preds = _exit_maps(model, images, pallas_head)
            exit_idx = _similarity_exits(preds, metric, tau, n_classes, ignore, skip)
            valid = torch.arange(images.shape[0], device=device) < count
            bucketed, chosen_conf = _bucketed_confusion_masked(
                preds, labels, exit_idx, valid, num_classes=n_classes)
            bucketed = bucketed.double().cpu().numpy()
            for e in range(n_exits):
                accs[e].accumulator += bucketed[e]
            accs[-1].accumulator += chosen_conf.double().cpu().numpy()
            counts[:n_exits] += np.bincount(exit_idx[:count].cpu().numpy(), minlength=n_exits)
            counts[-1] += count
    return _finalize_gated(accs, counts, n_branches, tau, {"metric": metric})


def br_evaluator_similarity(
    model, n_exits, n_classes, loader, metric, tau, *, ignore=(), skip=0,
    image_level: bool = False,
):
    """The similarity-gated policy with the plain head;
    ``image_level=True`` mirrors eval_br_images.py: per-image mIoU
    accumulators (``img_mIoU`` over ``n_classes + 1`` classes, the void id
    included) instead of confusion matrices.  Each image's score is that of
    the exit it takes; only (N,) scores and exit indices reach the host."""
    if not image_level:
        return br_evaluator_similarity_fused(model, n_exits, n_classes, loader, metric, tau,
                                             ignore=ignore, skip=skip)
    n_branches = n_exits - 1
    accs = [img_mIoU(num_classes=n_classes + 1) for _ in range(n_exits + 1)]
    counts = np.zeros(n_exits + 1, np.int64)
    device = _device_of(model)
    model.eval()
    with torch.inference_mode():
        for batch in loader:
            count = int(batch.get("count", len(batch["image"])))
            images, labels = _to_device(batch, device)
            preds = _exit_maps(model, images, pallas_head=False)[:, :count]
            exit_idx = _similarity_exits(preds, metric, tau, n_classes, ignore, skip)
            chosen = preds[exit_idx, torch.arange(count, device=device)]
            scores = _img_miou_one(chosen.flatten(1), labels[:count].flatten(1), n_classes + 1)
            for e, score in zip(exit_idx.tolist(), scores.tolist()):
                accs[e].add_score(score)
                accs[-1].add_score(score)
                counts[e] += 1
            counts[-1] += count
    return _finalize_gated(accs, counts, n_branches, tau, {"metric": metric})
