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

``GatedForward`` is the same forward for ``torch.export`` (``ee/aot.py``):
each stage under ``torch.cond`` on ``alive.any()``, no host read.

With a data-parallel ``mesh`` (``parallel/mesh.py``; the JAX package's
``shard_map`` branch) every rank gets the same micro-batch, pads it to a
multiple of the world size with repeats of its last row and runs the gated
forward on its block of rows, so its stage skips are its own: a rank whose
rows have all exited skips its remaining segments while another still
computes.  The label maps and exits are gathered in global row order, so
every rank returns the whole micro-batch's; rows never interact, so they
equal the one-process rows bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import SIM_GREATER, norm_entropy, similarity
from ee_semantic_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_entropy_argmax,
)
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm


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
    mesh=None,
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
    kernels B and C compute the heads.  ``mesh``: every rank passes the
    same x (on any device) and gets the whole micro-batch's result; each
    runs its block of rows (module docstring).
    """
    body = _gated_forward_fn(model, tau=tau, n_classes=n_classes, skip=skip, pool=pool,
                             pool_size=pool_size, pallas_head=pallas_head, metric=metric,
                             sim_ignore=sim_ignore)
    return body if mesh is None else _sharded(body, mesh)


def _sharded(body, mesh):
    """``fn(x)``: ``body`` on this rank's block of x padded to a multiple
    of the world size (``parallel/mesh.shard_batch``), its (labels,
    exit_idx) gathered in global row order and trimmed to x's rows."""

    def fn(x):
        N = x.shape[0]
        labels, exits = body(pm.shard_batch(mesh, x, pad=True).to(mesh.device))
        return (pm.all_gather(labels, mesh).flatten(0, 1)[:N],
                pm.all_gather(exits, mesh).flatten(0, 1)[:N])

    fn.kernel_head = body.kernel_head
    return fn


class _Carry(NamedTuple):
    """A micro-batch's state between stages: which rows are alive, the
    chosen label maps and 1-based exits, and for the similarity gate each
    row's previous exit map and whether it has one."""

    alive: torch.Tensor
    labels: torch.Tensor
    exit_idx: torch.Tensor
    ref_map: torch.Tensor
    has_ref: torch.Tensor


class _GatePolicy:
    """The gated forward's heads and exit decisions, shared by the eager
    engine (``_gated_forward_fn``) and the exportable one
    (``GatedForward``)."""

    def __init__(self, model, *, tau, n_classes=21, skip=0, pool="none", pool_size=1,
                 pallas_head=False, metric="ent", sim_ignore=()):
        metric = metric.lower()
        self.entropy_gate = metric in ("ent", "max", "min")
        if metric in ("max", "min") and pool == "none":
            pool, metric = metric, "ent"
        self.model, self.tau, self.n_classes, self.skip = model, tau, n_classes, skip
        self.pool, self.pool_size, self.metric = pool, pool_size, metric
        self.use_kernel = pallas_head and pool == "none" and self.entropy_gate
        self.sim_ignore = tuple(sim_ignore)
        self.n = model.config.n_branches

    def branch_labels(self, k, f, out_hw, ref_map):
        """Gated branch k on features f -> (label map, gate value), (N, H, W)
        int32 and (N,) float32."""
        model = self.model
        if self.use_kernel:
            return upsample_entropy_argmax(model._nhwc(model.branches[k](f)), out_hw)
        logits = model.run_branch(k, f, out_hw)
        lab = logits.argmax(dim=-1).int()
        if self.entropy_gate:
            probs = torch.softmax(logits.float(), dim=-1)
            return lab, norm_entropy(probs, self.n_classes, self.pool, self.pool_size)
        return lab, similarity(ref_map, lab, self.metric, self.n_classes,
                               self.sim_ignore).float()

    def final_labels(self, f, out_hw):
        if self.use_kernel:
            return upsample_argmax(self.model._nhwc(self.model.classifier(f)), out_hw)
        return self.model.run_classifier(f, out_hw).argmax(dim=-1).int()

    def start(self, x) -> _Carry:
        """The carry of a micro-batch x (N, H, W, 3) before its first stage."""
        N, H, W = x.shape[:3]
        dev = x.device
        return _Carry(torch.ones((N,), dtype=torch.bool, device=dev),
                      torch.zeros((N, H, W), dtype=torch.int32, device=dev),
                      torch.full((N,), self.n + 1, dtype=torch.int32, device=dev),
                      torch.zeros((N, H, W), dtype=torch.int32, device=dev),
                      torch.zeros((N,), dtype=torch.bool, device=dev))

    def decide(self, k, lab_k, gate_k, carry: _Carry) -> _Carry:
        """The exit decisions after gated branch k (k >= skip)."""
        alive, labels, exit_idx, ref_map, has_ref = carry
        if self.entropy_gate:
            fired = alive & (gate_k < self.tau)
        else:
            cmp = gate_k > self.tau if self.metric in SIM_GREATER else gate_k < self.tau
            # the first evaluated branch only seeds the reference map
            fired = alive & has_ref & cmp
            upd = alive & ~fired
            ref_map = torch.where(upd[:, None, None], lab_k, ref_map)
            has_ref = has_ref | upd
        labels = torch.where(fired[:, None, None], lab_k, labels)
        exit_idx = torch.where(fired, k + 1, exit_idx)
        return _Carry(alive & ~fired, labels, exit_idx, ref_map, has_ref)

    def finish(self, final_labels, carry: _Carry):
        """(labels, exit_idx) once the final head's maps are in: rows still
        alive take them."""
        return torch.where(carry.alive[:, None, None], final_labels, carry.labels), carry.exit_idx


def _gated_forward_fn(model, **kw):
    policy = _GatePolicy(model, **kw)
    n, skip = policy.n, policy.skip
    model.eval()

    @torch.inference_mode()
    def gated_forward(x):
        out_hw = tuple(x.shape[1:3])
        carry = policy.start(x)
        feats = x.permute(0, 3, 1, 2)  # NCHW once; the segments take NCHW features
        for k in range(n + 1):
            if not carry.alive.any():  # one host read a stage; alive only falls
                return carry.labels, carry.exit_idx
            feats = model.run_segment(k, feats)
            if k == n:
                return policy.finish(policy.final_labels(feats, out_hw), carry)
            if k >= skip:
                carry = policy.decide(
                    k, *policy.branch_labels(k, feats, out_hw, carry.ref_map), carry)

    gated_forward.kernel_head = policy.use_kernel
    return gated_forward


class GatedForward(torch.nn.Module):
    """The gated forward of ``make_masked_gated_apply`` as a module that
    ``torch.export`` can trace (``ee/aot.export_gated``): the same heads
    and decisions, with each stage under ``torch.cond(alive.any(), ...)``
    (the JAX package's ``lax.cond``) in place of the eager engine's host
    read.  A skipped stage yields zero features of the segment's output
    shape, computed from the backbone's geometry.  Takes the arguments of
    :func:`make_masked_gated_apply`; ``forward(x)`` returns the same
    ``(labels, exit_idx)``.  Its ``kernel_head`` says which head it runs."""

    def __init__(self, model, **kw):
        super().__init__()
        self.model = model.eval()
        self.policy = _GatePolicy(model, **kw)
        self.kernel_head = self.policy.use_kernel

    def _segment_out(self, k, H, W):
        """(C, h, w) of segment k's output for an (H, W) image."""
        spec, cfg = self.model.spec, self.model.config
        end = (list(cfg.segment_ends) + [len(spec.blocks)])[k]
        return spec.blocks[end - 1].out_shape(*spec.block_geometry(H, W)[end - 1][:2])[::-1]

    def forward(self, x):
        policy, model = self.policy, self.model
        n, skip = policy.n, policy.skip
        N, H, W = x.shape[:3]
        out_hw = (H, W)
        carry = policy.start(x)
        feats = x.permute(0, 3, 1, 2)
        for k in range(n):
            # both branches give channels-last features (an NHWC image
            # permuted to NCHW is channels-last, and the convs keep it)
            def stage(f, ref, k=k):
                f2 = model.run_segment(k, f).contiguous(memory_format=torch.channels_last)
                if k < skip:
                    return (f2, torch.zeros((N, H, W), dtype=torch.int32, device=f.device),
                            torch.full((N,), torch.inf, device=f.device))
                return (f2, *policy.branch_labels(k, f2, out_hw, ref))

            def dead(f, ref, k=k):
                c, h, w = self._segment_out(k, H, W)
                return (torch.zeros((N, h, w, c), dtype=f.dtype,
                                    device=f.device).permute(0, 3, 1, 2),
                        torch.zeros((N, H, W), dtype=torch.int32, device=f.device),
                        torch.full((N,), torch.inf, device=f.device))

            feats, lab_k, gate_k = torch.cond(carry.alive.any(), stage, dead,
                                              (feats, carry.ref_map))
            if k >= skip:
                carry = policy.decide(k, lab_k, gate_k, carry)

        lab_last = torch.cond(
            carry.alive.any(), lambda f: policy.final_labels(model.run_segment(n, f), out_hw),
            lambda f: torch.zeros((N, H, W), dtype=torch.int32, device=f.device), (feats,))
        return policy.finish(lab_last, carry)


def make_masked_gated_scan(model, mesh=None, **kw):
    """Build ``fn(xs) -> (labels, exit_idx)`` over stacked micro-batches.

    xs: (S, B, H, W, 3), S micro-batches of B images, run one after another
    through the gated forward (the JAX package's ``lax.scan``); each skips
    its segments on its own.  Returns (S, B, H, W) labels and (S, B) exit
    indices.  ``mesh``: each micro-batch's rows are sharded over the ranks,
    as in :func:`make_masked_gated_apply`."""
    body = _gated_forward_fn(model, **kw)
    if mesh is not None:
        body = _sharded(body, mesh)

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
