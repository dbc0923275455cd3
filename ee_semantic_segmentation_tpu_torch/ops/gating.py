"""Gates of the early-exit policy (PyTorch): entropy and label-map similarity.

Port of ``ee_semantic_segmentation_tpu/ops/gating.py``.

Entropy: ``pixel_entropy`` (softmax entropy normalised to base
``n_classes``), ``_block_reduce`` (skimage ``block_reduce`` with cval=0 edge
padding — the reference's quirk that biases min-pooling at borders is
kept), ``norm_entropy`` and ``batched_norm_entropy``.  These serve ``-m
max|min`` and are the plain version that the fused entropy kernel
(ops/kernels/upsample_argmax.py) is held against.

Similarity of two integer label maps (the reference's sim_metrics.py), all
batched over leading dimensions:

* ``ssim_int`` — skimage ``structural_similarity`` defaults: 7x7 uniform
  windows, K1=.01, K2=.03, covariance x 49/48, mean over the fully valid
  windows.  The window sums of a, b, a², b² and ab are integer sums, taken
  exactly in int32 and then divided by 49 in float32 as the JAX package
  does;
* ``mse_int`` — mean squared difference;
* ``nmi`` — (H(a) + H(b)) / H(a, b) from the joint label histogram;
* ``vi`` / ``seg_comp`` — variation of information H(b|a) + H(a|b) in bits,
  or one of its terms, with skimage's ``ignore_labels`` semantics (pixels
  whose first-map label is ignored drop out).

The joint histogram is one ``torch.bincount`` of ``a * n + b`` for all
images at once (the JAX package takes a one-hot product); its counts are
exact.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn


def pixel_entropy(probs: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(..., C) probabilities -> (...,) entropy normalized to base n_classes."""
    p = probs.clamp(1e-12, 1.0)
    h = -torch.where(probs > 0, probs * torch.log(p), torch.zeros_like(p)).sum(dim=-1)
    return h / math.log(float(n_classes))


def _block_reduce(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """skimage.measure.block_reduce over trailing (H, W): pad partial blocks
    with 0 (cval=0), reduce with max or min."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % size, (-w) % size
    if ph or pw:
        x = Fn.pad(x, (0, pw, 0, ph), value=0.0)
    nh, nw = x.shape[-2] // size, x.shape[-1] // size
    x = x.reshape(x.shape[:-2] + (nh, size, nw, size))
    return x.amax(dim=(-3, -1)) if mode == "max" else x.amin(dim=(-3, -1))


def norm_entropy(probs_hwc: torch.Tensor, n_classes: int, pool: str = "none",
                 size: int = 1) -> torch.Tensor:
    """Image-level normalized entropy (img_norm_entropy, eval_br_ent.py:19-36).

    probs_hwc: (..., H, W, C) softmax probabilities.  Returns the mean over
    (H, W), one value per leading index.
    """
    ent = pixel_entropy(probs_hwc, n_classes)  # (..., H, W)
    if pool in ("max", "min") and size != 1:
        ent = _block_reduce(ent, size, pool)
    return ent.mean(dim=(-2, -1))


def batched_norm_entropy(stacked_logits: torch.Tensor, n_classes: int,
                         pool: str = "none", size: int = 1) -> torch.Tensor:
    """(E, N, H, W, C) logits -> (E, N) mean normalized entropy per image."""
    probs = torch.softmax(stacked_logits.float(), dim=-1)
    return norm_entropy(probs, n_classes, pool, size)


# --------------------------------------------------------------- similarity
SIM_GREATER = ("ssim", "nmi")  # gate fires on sim > tau for these (eval_br_sim.py:43)


def _window_sums(x: torch.Tensor, win: int) -> torch.Tensor:
    """Sum over every fully valid win x win window of the trailing (H, W)
    -> (..., H - win + 1, W - win + 1), exact for int32 input."""
    x = x.unfold(-2, win, 1).sum(-1, dtype=torch.int32)
    return x.unfold(-1, win, 1).sum(-1, dtype=torch.int32)


def ssim_int(a: torch.Tensor, b: torch.Tensor, data_range: float, win: int = 7) -> torch.Tensor:
    """skimage structural_similarity defaults on (..., H, W) label maps ->
    (...,) float32."""
    a, b = a.to(torch.int32), b.to(torch.int32)
    n = win * win
    cov_norm = n / (n - 1.0)

    def mean(x):  # exact window sum, then the JAX package's division
        return _window_sums(x, win).to(torch.float32) / n

    ux, uy = mean(a), mean(b)
    uxx, uyy, uxy = mean(a * a), mean(b * b), mean(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(-2, -1))


def mse_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., H, W) label maps -> (...,) float32 mean squared difference."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).mean(dim=(-2, -1))


def _joint_hist(a: torch.Tensor, b: torch.Tensor, n: int, keep=None) -> torch.Tensor:
    """(..., H, W) label maps -> (..., n, n) float32 joint counts [a, b];
    labels outside [0, n) and pixels where ``keep`` is False count nowhere."""
    lead = a.shape[:-2]
    a = a.reshape(-1, a.shape[-2] * a.shape[-1]).long()
    b = b.reshape(a.shape).long()
    inside = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    if keep is not None:
        inside &= keep.reshape(a.shape)
    k = a.shape[0]
    offset = torch.arange(k, device=a.device)[:, None] * (n * n)
    idx = torch.where(inside, offset + a * n + b, k * n * n)  # the last bin is dropped
    counts = torch.bincount(idx.reshape(-1), minlength=k * n * n + 1)[: k * n * n]
    return counts.reshape(*lead, n, n).to(torch.float32)


def _entropy_nat(p: torch.Tensor, dims) -> torch.Tensor:
    return -torch.where(p > 0, p * torch.log(p.clamp(1e-30, 1.0)), 0.0).sum(dim=dims)


def nmi(a: torch.Tensor, b: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(H(a) + H(b)) / H(a, b) from the joint label histogram."""
    j = _joint_hist(a, b, n_classes)
    p = j / j.sum(dim=(-2, -1), keepdim=True)
    ha = _entropy_nat(p.sum(-1), -1)
    hb = _entropy_nat(p.sum(-2), -1)
    hab = _entropy_nat(p, (-2, -1))
    return (ha + hb) / hab.clamp_min(1e-12)


def _vi_terms(a, b, n_classes: int, ignore=()):
    """Conditional entropies (H(b|a), H(a|b)) in bits; pixels whose label in
    ``a`` is in ``ignore`` drop out."""
    keep = torch.ones_like(a, dtype=torch.bool)
    for ig in ignore:
        keep &= a != ig
    j = _joint_hist(a, b, n_classes, keep)
    p = j / j.sum(dim=(-2, -1), keepdim=True).clamp_min(1.0)
    log2 = math.log(2.0)
    ha = _entropy_nat(p.sum(-1), -1) / log2
    hb = _entropy_nat(p.sum(-2), -1) / log2
    hab = _entropy_nat(p, (-2, -1)) / log2
    return hab - ha, hab - hb


def vi(a, b, n_classes: int, ignore=()):
    """Variation of information = H(b|a) + H(a|b) (sim_metrics.py:78-99)."""
    h_b_a, h_a_b = _vi_terms(a, b, n_classes, ignore)
    return h_b_a + h_a_b


def seg_comp(a, b, n_classes: int, x_y: bool = True, ignore=()):
    """One VI term (sim_metrics.py:101-123): x_y=True -> H(a|b), else H(b|a)."""
    terms = _vi_terms(a, b, n_classes, ignore)
    return terms[1] if x_y else terms[0]


def similarity(a, b, metric: str, n_classes: int, ignore=()):
    """Dispatch by metric name (the eval_br_sim.py:20-31 registry)."""
    m = metric.lower()
    if m == "ssim":
        return ssim_int(a, b, data_range=n_classes - 1)
    if m == "nmi":
        return nmi(a, b, n_classes)
    if m == "vi":
        return vi(a, b, n_classes, ignore)
    if m == "h_xy":
        return seg_comp(a, b, n_classes, x_y=True, ignore=ignore)
    if m == "h_yx":
        return seg_comp(a, b, n_classes, x_y=False, ignore=ignore)
    return mse_int(a, b)


def batched_similarity(preds: torch.Tensor, metric: str, n_classes: int, ignore=()):
    """(E, N, H, W) label maps -> (E-1, N) similarity of consecutive exits."""
    return similarity(preds[:-1], preds[1:], metric, n_classes, ignore)
