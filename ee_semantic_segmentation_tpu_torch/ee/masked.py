"""Masked gated inference: the early-exit policy over a fixed micro-batch,
skipping a segment once every image in it has exited.

Port of ``ee_semantic_segmentation_tpu/ee/masked.py``.  The micro-batch
keeps its size from the first segment to the last:

* the exit decisions are a boolean ``alive`` vector, one entry an image,
  with the chosen ``labels``, the 1-based ``exit_idx`` (n + 1 = the final
  classifier) and, for the similarity gate, each row's previous exit map
  (``ref_map``, ``has_ref``) carried from stage to stage;
* before each stage one host read asks whether any row is still alive
  (``if alive.any():``, where the JAX package compiles ``lax.cond``).
  ``alive`` only falls, so once it is all False no later segment, branch
  head or classifier runs;
* rows that have exited are not taken out: every stage runs on all rows,
  as in the JAX package, so the convolutions see one batch shape.

With ``pallas_head`` and the entropy gate without pooling, each gated
branch's low-res logits go through kernel B (``upsample_entropy_argmax``:
label map and gate value in one pass) and the final classifier's through
kernel C (``upsample_argmax``), so no upsampled logits exist.  A pooled or
similarity gate runs the plain head, as in the JAX package; the returned
function's ``kernel_head`` says which head it runs.

The JAX package's ``mesh``/``shard_map`` variants are not ported (multi-GPU
is a ROADMAP.md item).
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import SIM_GREATER, norm_entropy, similarity
from ee_semantic_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_entropy_argmax,
)


def make_masked_gated_apply(
    model,
    *,
    tau: float,
    n_classes: int = 21,
    skip: int = 0,
    pool: str = "none",
    pool_size: int = 1,
    pallas_head: bool = False,
    metric: str = "ent",
    sim_ignore=(),
):
    """Build ``fn(x) -> (labels, exit_idx)``, the gated early-exit forward of
    one micro-batch.  ``metric='ent'`` is the entropy gate
    (ee_dnn_op_ne.py:51-108); a similarity metric ('ssim' | 'mse' | 'nmi' |
    'vi' | 'h_xy' | 'h_yx') is the exit-vs-previous-exit gate
    (ee_dnn_op.py:84-94): the first evaluated branch only seeds the
    reference map, later branches fire when the similarity crosses tau
    (> tau for ssim and nmi, < tau otherwise).

    x: (N, H, W, 3) preprocessed images on the model's device.
    labels: (N, H, W) int32 label map of each image's chosen exit.
    exit_idx: (N,) int32, the 1-based exit (n + 1 = the final classifier).

    Branches k < skip are not gated.  ``fn.kernel_head`` is True where the
    kernels B and C compute the heads.
    """
    return _gated_forward_fn(model, tau=tau, n_classes=n_classes, skip=skip, pool=pool,
                             pool_size=pool_size, pallas_head=pallas_head, metric=metric,
                             sim_ignore=sim_ignore)


def _gated_forward_fn(model, *, tau, n_classes=21, skip=0, pool="none", pool_size=1,
                      pallas_head=False, metric="ent", sim_ignore=()):
    n = model.config.n_branches
    metric = metric.lower()
    entropy_gate = metric in ("ent", "max", "min")
    if metric in ("max", "min") and pool == "none":
        pool, metric = metric, "ent"
    use_kernel = pallas_head and pool == "none" and entropy_gate
    sim_ignore = tuple(sim_ignore)
    model.eval()

    def branch_labels(k, f, out_hw, ref_map):
        """Gated branch k on features f -> (label map, gate value), (N, H, W)
        int32 and (N,) float32."""
        if use_kernel:
            return upsample_entropy_argmax(model._nhwc(model.branches[k](f)), out_hw)
        logits = model.run_branch(k, f, out_hw)
        lab = logits.argmax(dim=-1).int()
        if entropy_gate:
            probs = torch.softmax(logits.float(), dim=-1)
            return lab, norm_entropy(probs, n_classes, pool, pool_size)
        return lab, similarity(ref_map, lab, metric, n_classes, sim_ignore).float()

    def final_labels(f, out_hw):
        if use_kernel:
            return upsample_argmax(model._nhwc(model.classifier(f)), out_hw)
        return model.run_classifier(f, out_hw).argmax(dim=-1).int()

    @torch.inference_mode()
    def gated_forward(x):
        N, H, W = x.shape[:3]
        out_hw = (H, W)
        dev = x.device
        alive = torch.ones((N,), dtype=torch.bool, device=dev)
        labels = torch.zeros((N, H, W), dtype=torch.int32, device=dev)
        exit_idx = torch.full((N,), n + 1, dtype=torch.int32, device=dev)
        # similarity gate carry: previous exit's label map per row
        ref_map = torch.zeros((N, H, W), dtype=torch.int32, device=dev)
        has_ref = torch.zeros((N,), dtype=torch.bool, device=dev)

        feats = x.permute(0, 3, 1, 2)  # NCHW once; the segments take NCHW features
        for k in range(n + 1):
            if not alive.any():  # one host read a stage; alive only falls
                break
            feats = model.run_segment(k, feats)
            if k == n:
                labels = torch.where(alive[:, None, None], final_labels(feats, out_hw), labels)
            elif k >= skip:
                lab_k, gate_k = branch_labels(k, feats, out_hw, ref_map)
                if entropy_gate:
                    fired = alive & (gate_k < tau)
                else:
                    cmp = gate_k > tau if metric in SIM_GREATER else gate_k < tau
                    # the first evaluated branch only seeds the reference map
                    fired = alive & has_ref & cmp
                    upd = alive & ~fired
                    ref_map = torch.where(upd[:, None, None], lab_k, ref_map)
                    has_ref = has_ref | upd
                labels = torch.where(fired[:, None, None], lab_k, labels)
                exit_idx = torch.where(fired, k + 1, exit_idx)
                alive = alive & ~fired
        return labels, exit_idx

    gated_forward.kernel_head = use_kernel
    return gated_forward


def make_masked_gated_scan(model, **kw):
    """Build ``fn(xs) -> (labels, exit_idx)`` over stacked micro-batches.

    xs: (S, B, H, W, 3), S micro-batches of B images, run one after another
    through the gated forward (the JAX package's ``lax.scan``); each skips
    its segments on its own.  Returns (S, B, H, W) labels and (S, B) exit
    indices."""
    body = _gated_forward_fn(model, **kw)

    def scan_all(xs):
        outs = [body(x) for x in xs]
        return torch.stack([l for l, _ in outs]), torch.stack([e for _, e in outs])

    scan_all.kernel_head = body.kernel_head
    return scan_all


def gated_flops_per_image(model, exit_counts, skip: int = 0, img_dim=None,
                          exclude_first_branch: bool = False):
    """Average FLOPs an image given per-exit counts (1-based exit -> count),
    priced by the analytic table: the reference's ``avg_flops`` CSV column
    (ee_dnn_op_ne.py:194-206).

    ``exclude_first_branch`` drops the first *evaluated* branch head's cost
    (branch ``skip``): the reference CSV's ``_2`` columns
    (ee_dnn_op.py:106-117).
    """
    table = model.flops_table(img_dim)
    seg, br = table["segments"], table["branches"]
    n = model.config.n_branches
    total = 0.0
    count = 0
    for e, c in exit_counts.items():
        e = int(e)
        # trunk through segment e-1 (exit e means branch e fired after
        # segment e; the final exit n+1 pays every segment + the classifier)
        cost = sum(seg[:min(e, n + 1)])
        # every gated branch head up to the firing one runs
        first = skip + 1 if exclude_first_branch else skip
        for k in range(first, min(e, n)):
            cost += br[k]
        if e == n + 1:
            cost += br[-1]
        total += cost * c
        count += c
    return total / max(count, 1)
