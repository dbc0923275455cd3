"""Lovász-Softmax loss: the exact, sorted form and the sort-free histogram
form (channels-last).

Port of ``ee_semantic_segmentation_tpu/ops/lovasz.py`` (``lovasz_grad``,
``_class_loss``, ``_hist_class_loss``, ``lovasz_softmax_flat``,
``lovasz_softmax``), with the same fixed-shape masked semantics: void
pixels keep their slots with an error of -1e30, so one ascending sort of
the negated errors pushes them to the tail, and their contributions are
masked to zero.  The value is invariant to the order within tied errors.

The JAX package ``vmap``s one sort per (exit, image or batch, class); here
every such row is one row of a single (R, P) tensor, so a loss call makes
one forward sort and one backward unsort (``ops/kernels/sort.py``: kernel D
and its permutation scatter on CUDA tensors).  ``_ClassLoss`` is the
``custom_vjp`` as a ``torch.autograd.Function``: the Lovász weight vector
is a constant in the backward (the reference detaches it), and the backward
puts the gradient back in pixel order with one scatter on the saved
positions, ``out[perm[i]] = grad_sorted[i]``.  The JAX package unsorts with
a second sort keyed on those positions because a scatter is slow on the
TPU; the positions are a permutation, so both give the same values.

The payload of the forward sort is the int32 ``pos << 2 | fg << 1 |
valid``, moved as raw bits: exact for every P < 2^30, so the JAX package's
second branch for ``4P - 1 > 2^24`` (its float32 packing, a workaround of
a TPU compiler hang) has no counterpart.

The histogram form (``hist_bins``, the training CLI's ``-G``) replaces
the sort and the unsort: each row's errors fall into ``hist_bins``
uniform-width descending buckets, the Lovász weights telescope over them,
and a call makes one histogram launch forward (kernel E) and one table
lookup backward (kernel F, ``ops/kernels/hist.py``).  It is approximate: a row's
loss is within (max error - min error) / hist_bins of the exact one.

Data parallelism (``mesh``, a ``parallel/mesh.DataMesh``): each rank
holds its rows of the global batch, and the loss keeps its global-batch
meaning, as the JAX package's does under GSPMD.  The per-batch sorted
form gathers every rank's error, label and validity columns in rank order
(the global pixel order), takes the present and most-frequent classes
over the global labels, and sorts and unsorts the gathered rows (kernels
D and D'), so every rank computes the one global loss; the backward
returns this rank's columns.  The histogram form needs no gather: the
error range is all-reduced (max, min) before kernel E, E's histograms are
all-reduced (sum) before the tables, and kernel F looks up this rank's own
pixels.  The per-image form is local to each image, and its mean divides
by the global image count.  A distributed sort in place of the gather is a
ROADMAP.md item.

Layout: ``probas`` is (N, H, W, C) or (P, C), labels (N, H, W) or (P,).
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.kernels.hist import (
    hist2d_weighted,
    hist_bins_ok,
    table_lookup,
)
from ee_semantic_segmentation_tpu_torch.ops.kernels.sort import sort_rows, unsort_rows
from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

_NEG_BIG = -1e30
_POS_MASK = (1 << 30) - 1
HIST_KERNELS = (hist2d_weighted, table_lookup)
SORT_KERNELS = (sort_rows, unsort_rows)


def lovasz_grad(gt_sorted: torch.Tensor, valid_sorted: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors, along the
    last axis (lovaszsoftmax.py:19-31 with a validity mask: invalid slots
    add nothing to the cumulative sums and get a zero gradient)."""
    dtype = torch.promote_types(gt_sorted.dtype, torch.float32)
    gt_sorted = gt_sorted.to(dtype)
    valid_sorted = (torch.ones_like(gt_sorted) if valid_sorted is None
                    else valid_sorted.to(dtype))
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (valid_sorted - gt_sorted).cumsum(-1)
    jaccard = 1.0 - torch.where(union > 0, intersection / torch.where(union > 0, union, 1.0), 0.0)
    delta = torch.diff(jaccard, dim=-1, prepend=jaccard.new_zeros(jaccard.shape[:-1] + (1,)))
    return delta * valid_sorted


class _ClassLoss(torch.autograd.Function):
    """Lovász loss of every row of (R, P) errors at once.

    ``errors``: raw ``|fg - pred|`` with void slots already at -1e30;
    ``fg``, ``valid``: (R, P) bool.  Returns the (R,) losses.  The gradient
    flows to ``errors`` only: d loss / d errors[r, p] = the Lovász weight
    at p's rank in row r.  ``sort`` and ``unsort`` are kernel D and its
    backward call or their plain versions.
    """

    @staticmethod
    def forward(ctx, errors, fg, valid, sort, unsort):
        R, P = errors.shape
        if P > _POS_MASK + 1:
            raise ValueError(f"rows of {P} pixels: the packed position needs P <= 2^30")
        pos = torch.arange(P, dtype=torch.int32, device=errors.device)
        pay = (pos << 2) | (fg.to(torch.int32) << 1) | valid.to(torch.int32)
        neg_sorted, pay_sorted = sort(-errors, pay)
        perm = (pay_sorted >> 2) & _POS_MASK
        # float32 weights whatever the errors' dtype, as in the JAX package
        # (its fg indicator is float32, so lovasz_grad runs in float32)
        fg_s = ((pay_sorted >> 1) & 1).to(torch.float32)
        valid_s = (pay_sorted & 1).to(torch.float32)
        grad = lovasz_grad(fg_s, valid_s)
        errors_sorted = torch.where(valid_s > 0, -neg_sorted, 0.0)
        ctx.save_for_backward(perm, grad * valid_s)
        ctx.unsort = unsort
        return (errors_sorted * grad).sum(-1)

    @staticmethod
    def backward(ctx, ct):
        perm, grad_sorted = ctx.saved_tensors
        # unsort: each row of perm is a permutation of 0..P-1
        d_err = ctx.unsort(perm, (grad_sorted * ct[:, None]).contiguous())
        return d_err, None, None, None, None


def _hist_prepass(errors, valid, bins: int, mesh=None):
    """Per-row (emax, inv_bucket_width) over the valid errors (of every
    rank, with a mesh); zeros for a row without any."""
    if errors.shape[-1]:
        emax = torch.where(valid, errors, -torch.inf).amax(-1)
        emin = torch.where(valid, errors, torch.inf).amin(-1)
    else:  # an empty shard
        emax = errors.new_full(errors.shape[:-1], -torch.inf)
        emin = errors.new_full(errors.shape[:-1], torch.inf)
    if mesh is not None:
        pm.all_reduce(emax, mesh, "max")
        pm.all_reduce(emin, mesh, "min")
    any_valid = emax > -torch.inf
    rng = (emax - emin).clamp_min(1e-12)
    return torch.where(any_valid, emax, 0.0), torch.where(any_valid, bins / rng, 0.0)


def _hist_tables(hist):
    """(R, 4, bins) [n, f, S, Sf] histograms -> ((R,) losses, (R, 2, bins)
    [fg, bg] per-bucket weights).

    Within a bucket the order is taken as foreground first, and each pixel
    of a (bucket, fg) group gets the group's mean Jaccard step, so the
    weights summed over a bucket are exact.  The weights depend on the
    counts alone."""
    n, f, S, Sf = hist.unbind(1)
    gts = f.sum(-1, keepdim=True)
    n_end, f_end = n.cumsum(-1), f.cumsum(-1)
    n_start, f_start = n_end - n, f_end - f

    def jaccard(cnt, cfg):
        inter = gts - cfg
        union = gts + cnt - cfg
        j = 1.0 - torch.where(union > 0, inter / union.clamp_min(1e-30), 0.0)
        return torch.where(cnt > 0, j, 0.0)  # J(0) := 0, lovasz_grad's prepend

    j_start = jaccard(n_start, f_start)
    j_mid = jaccard(n_start + f, f_start + f)
    j_end = jaccard(n_end, f_end)
    c = n - f
    g_fg = torch.where(f > 0, (j_mid - j_start) / f.clamp_min(1e-30), 0.0)
    g_bg = torch.where(c > 0, (j_end - j_mid) / c.clamp_min(1e-30), 0.0)
    loss = (g_fg * Sf).sum(-1) + (g_bg * (S - Sf)).sum(-1)
    return loss, torch.stack([g_fg, g_bg], dim=1)


class _HistClassLoss(torch.autograd.Function):
    """Histogram Lovász of every row of (R, P) errors at once.

    Same contract as :class:`_ClassLoss`; d loss / d errors[r, p] is the
    mean Jaccard step of p's (bucket, fg) group in row r, looked up from
    the weight tables saved by the forward.  ``hist`` and ``lookup`` are
    kernels E and F or their plain versions.  With a ``mesh`` the rows are
    this rank's columns of global rows: the error range and E's
    histograms are all-reduced, so the losses are the global rows'."""

    @staticmethod
    def forward(ctx, errors, fg, valid, bins, hist, lookup, mesh=None):
        errors, fg = errors.contiguous(), fg.contiguous()
        emax, inv_w = _hist_prepass(errors, valid, bins, mesh)
        counts = hist(errors, fg, emax, inv_w, bins=bins)
        if mesh is not None:
            pm.all_reduce(counts, mesh)
        loss, tables = _hist_tables(counts)
        ctx.save_for_backward(errors, fg, emax, inv_w, tables)
        ctx.bins, ctx.lookup = bins, lookup
        return loss

    @staticmethod
    def backward(ctx, ct):
        errors, fg, emax, inv_w, tables = ctx.saved_tensors
        w = ctx.lookup(errors, fg, emax, inv_w, tables, bins=ctx.bins)
        return w * ct[:, None], None, None, None, None, None, None


def _class_counts(labels, valid, C: int) -> torch.Tensor:
    """(G, Pg) labels -> (G, C) int64 valid-pixel counts of classes [0, C)."""
    inside = valid & (labels >= 0) & (labels < C)
    counts = torch.zeros(labels.shape[0], C, dtype=torch.int64, device=labels.device)
    return counts.scatter_add_(1, labels.clamp(0, C - 1).to(torch.int64), inside.to(torch.int64))


def _most_frequent_classes(counts, k: int) -> torch.Tensor:
    """(G, C) class pixel counts -> (G, k) class ids: present classes by
    pixel count, most frequent first, then absent ones, ties in ascending
    class order (the JAX package's stable argsort), ranked by pairwise
    comparison of the C counts rather than by a sort."""
    C = counts.shape[-1]
    key = torch.where(counts > 0, -counts, 1)
    c = torch.arange(C, device=counts.device)
    before = (key[:, None, :] < key[:, :, None]) | (
        (key[:, None, :] == key[:, :, None]) & (c[None, :] < c[:, None]))
    rank = before.sum(-1)  # (G, C): the place of class c
    order = torch.empty_like(rank).scatter_(1, rank, c.expand_as(rank).contiguous())
    return order[:, :k]


def present_class_counts(labels, valid, C: int) -> torch.Tensor:
    """(G, Pg) labels -> (G,) number of classes in [0, C) with a valid pixel."""
    return (_class_counts(labels, valid, C) > 0).sum(-1)


def _exit_group_losses(probas, labels, valid, classes="present", max_present=None,
                       hist_bins=None, sort_kernels=SORT_KERNELS,
                       hist_kernels=HIST_KERNELS, mesh=None, cols=None) -> torch.Tensor:
    """Lovász of every (exit, group): ``probas`` (E, G, Pg, C), ``labels``
    and ``valid`` (G, Pg) -> (E, G) losses, from one sort (or, with
    ``hist_bins``, one histogram) of all E x G x classes rows.  A group is
    an image (per-image loss) or the flat batch.  With a ``mesh`` the one
    group (G = 1) is the global flat batch, of which this rank holds the
    Pg pixels of its rows and ``cols`` gives every rank's pixel count in
    rank order: the losses are the global batch's, equal on every rank."""
    if hist_bins is not None and not hist_bins_ok(hist_bins):
        raise ValueError(f"hist_bins={hist_bins} must be 128 * a power of two")
    E, G, Pg, C = probas.shape
    probas = probas.to(torch.promote_types(probas.dtype, torch.float32))
    labels = labels.to(torch.int64)
    scores = probas.transpose(-1, -2)  # (E, G, C, Pg)
    compact = classes == "present" and max_present is not None and 0 < max_present < C
    if compact or not isinstance(classes, str):
        if compact:
            counts = _class_counts(labels, valid, C)
            if mesh is not None:
                pm.all_reduce(counts, mesh)
            class_ids = _most_frequent_classes(counts, max_present)
        else:
            class_ids = torch.as_tensor(tuple(classes), dtype=torch.int64,
                                        device=labels.device).expand(G, -1)
        K = class_ids.shape[1]
        pred = torch.gather(scores, 2, class_ids[None, :, :, None].expand(E, G, K, Pg))
        ids = class_ids[:, :, None]  # (G, K, 1)
    else:
        K, pred = C, scores
        ids = torch.arange(C, device=labels.device)[None, :, None]
    fg = (labels[:, None, :] == ids) & valid[:, None, :]  # (G, K, Pg)
    errors = torch.where(valid[:, None, :], (fg.to(probas.dtype) - pred).abs(), _NEG_BIG)
    errors = errors.reshape(E * G * K, Pg)
    if mesh is not None and hist_bins is None:
        # the global rows, in rank order: every rank sorts the same rows
        errors = pm.gather_cols(errors, mesh, cols)
        labels = pm.all_gather_dim(labels, mesh, cols)
        valid = pm.all_gather_dim(valid.to(torch.uint8), mesh, cols).bool()
        fg = (labels[:, None, :] == ids) & valid[:, None, :]
        Pg = sum(cols)
    rows = (errors,
            fg.expand(E, G, K, Pg).reshape(E * G * K, Pg),
            valid[None, :, None, :].expand(E, G, K, Pg).reshape(E * G * K, Pg))
    if hist_bins is None:
        losses = _ClassLoss.apply(*rows, *sort_kernels)
    else:
        losses = _HistClassLoss.apply(*rows, hist_bins, *hist_kernels, mesh)
    losses = losses.view(E, G, K)
    if classes == "present":
        present = fg.any(-1)  # (G, K)
        if mesh is not None and hist_bins is not None:
            present = pm.all_reduce(present.to(torch.int32), mesh, "max").bool()
        n_present = present.sum(-1).to(losses.dtype)
        total = torch.where(present, losses, 0.0).sum(-1)
        return torch.where(n_present > 0, total / n_present.clamp_min(1.0), 0.0)
    return losses.mean(-1)


def _lovasz_exits(probas, labels, classes="present", per_image=False, ignore=None,
                  apply_softmax=False, max_present=None, hist_bins=None,
                  sort_kernels=SORT_KERNELS, hist_kernels=HIST_KERNELS,
                  mesh=None, rows=None) -> torch.Tensor:
    """Per-exit :func:`lovasz_softmax` of stacked (E, N, H, W, C) scores
    against shared (N, H, W) labels -> (E,), with one sort (or histogram)
    for all exits.  ``sort_kernels`` and ``hist_kernels`` are the (sort,
    unsort) and the (histogram, lookup) pairs to use (the tests and
    ``chip_smoke.py`` pass the plain versions).  ``mesh``: the rows are
    this rank's shard of the global batch, ``rows`` every rank's row
    count in rank order, and the losses are the global batch's (module
    docstring)."""
    if probas.ndim == 4:  # (E, N, H, W) sigmoid-style -> single channel
        probas = probas[..., None]
    E, N, H, W, C = probas.shape
    if mesh is not None and rows is None:
        raise ValueError("a data-parallel Lovász loss needs rows, every rank's row count")
    cols = None if rows is None else [r * H * W for r in rows]
    if apply_softmax:
        probas = torch.softmax(probas, dim=-1)
    flat_l = labels.reshape(N, H * W)
    valid = (torch.ones_like(flat_l, dtype=torch.bool) if ignore is None
             else flat_l != ignore)
    if per_image:
        per_group = _exit_group_losses(probas.reshape(E, N, H * W, C), flat_l, valid,
                                       classes, max_present, hist_bins, sort_kernels,
                                       hist_kernels)
        if mesh is None:
            return per_group.mean(-1)
        return pm.global_sum(per_group.sum(-1), mesh) / max(sum(rows), 1)
    return _exit_group_losses(probas.reshape(E, 1, N * H * W, C), flat_l.reshape(1, -1),
                              valid.reshape(1, -1), classes, max_present, hist_bins, sort_kernels,
                              hist_kernels, mesh, cols)[:, 0]


def lovasz_softmax_flat(probas, labels, classes="present", valid=None, max_present=None,
                        hist_bins=None) -> torch.Tensor:
    """Multi-class Lovász-Softmax on flat pixels (lovaszsoftmax.py:172-200):
    ``probas`` (P, C) scores, ``labels`` (P,) ints, ``valid`` (P,) bool or
    None (all valid).  ``max_present`` scores only the K most frequent
    present classes (with ``classes='present'``); ``hist_bins`` takes the
    histogram form.  Returns a scalar."""
    P, C = probas.shape
    valid = (torch.ones(P, dtype=torch.bool, device=labels.device) if valid is None
             else valid.to(torch.bool))
    return _exit_group_losses(probas.reshape(1, 1, P, C), labels.reshape(1, P),
                              valid.reshape(1, P), classes, max_present, hist_bins)[0, 0]


def lovasz_softmax(probas, labels, classes="present", per_image=False, ignore=None,
                   apply_softmax=False, max_present=None, hist_bins=None,
                   mesh=None, rows=None) -> torch.Tensor:
    """Multi-class Lovász-Softmax loss (lovaszsoftmax.py:154-169), NHWC.

    ``probas``: (N, H, W, C) scores (raw logits by default, as the
    reference's training loss passes them) or (N, H, W); ``labels``:
    (N, H, W) ints; ``ignore``: the void label, masked; ``per_image``: the
    mean of per-image losses instead of one flat batch; ``hist_bins``: the
    sort-free histogram form with this many buckets (128 times a power of
    two), approximate; ``mesh``: this rank's rows of a global batch, whose
    loss every rank returns, and ``rows`` every rank's row count."""
    return _lovasz_exits(probas[None], labels, classes, per_image, ignore, apply_softmax,
                         max_present, hist_bins, mesh=mesh, rows=rows)[0]
