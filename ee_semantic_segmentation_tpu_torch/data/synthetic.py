"""Synthetic segmentation data for tests and benchmarks (no dataset needed).

Generates deterministic image/label pairs with a learnable structure: labels
are smooth voronoi-ish regions, images are the label map rendered with
per-class colors + noise, so a model can actually fit them — used by the
convergence tests and by bench.py when VOC is absent.
"""

from __future__ import annotations

import numpy as np


class SyntheticSegDataset:
    def __init__(self, size: int | tuple[int, int] = 64, n: int = 32, num_classes: int = 21,
                 void: int | None = 21, void_frac: float = 0.05, seed: int = 0):
        self.size = size  # int (square) or (H, W)
        self.n = n
        self.num_classes = num_classes
        self.void = void
        self.void_frac = void_frac
        self.seed = seed
        # canonical per-class palette, INDEPENDENT of the split seed: the
        # seed picks which voronoi layouts a split holds, but the class ->
        # color mapping is the dataset's "semantics" and must be shared
        # across train/val/test — otherwise generalization is impossible by
        # construction and convergence-level comparisons (convergence_parity,
        # hist_lovasz_convergence) measure pure noise
        rng = np.random.RandomState(12345 + num_classes)
        self._colors = rng.rand(num_classes, 3).astype(np.float32)

    def __len__(self):
        return self.n

    def get(self, idx: int, rng=None):
        r = np.random.RandomState(self.seed * 100003 + idx)
        s = self.size
        h, w = (s, s) if isinstance(s, int) else s
        k = min(self.num_classes, 5)
        # voronoi labels from k random seed points with random classes
        pts = r.rand(k, 2) * np.array([h, w])
        cls = r.randint(0, self.num_classes, size=k)
        yy, xx = np.mgrid[0:h, 0:w]
        d = (yy[None] - pts[:, 0, None, None]) ** 2 + (xx[None] - pts[:, 1, None, None]) ** 2
        lab = cls[np.argmin(d, axis=0)].astype(np.int32)
        img = self._colors[lab] + 0.1 * r.randn(h, w, 3).astype(np.float32)
        if self.void is not None and self.void_frac > 0:
            mask = r.rand(h, w) < self.void_frac
            lab = np.where(mask, self.void, lab).astype(np.int32)
        return img.astype(np.float32), lab

    __getitem__ = get
