"""Entropy gate of the early-exit policy (PyTorch).

Port of the entropy half of ``ee_semantic_segmentation_tpu/ops/gating.py``:
``pixel_entropy`` (softmax entropy normalised to base ``n_classes``),
``_block_reduce`` (skimage ``block_reduce`` with cval=0 edge padding — the
reference's quirk that biases min-pooling at borders is kept),
``norm_entropy`` and ``batched_norm_entropy``.  These serve ``-m max|min``
and are the plain version that the fused entropy kernel
(ops/kernels/upsample_argmax.py) is held against.
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
