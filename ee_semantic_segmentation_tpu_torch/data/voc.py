"""Pascal VOC segmentation dataset reader (no torchvision dependency).

Reads the standard VOCdevkit layout that torchvision's ``VOCSegmentation``
uses (the reference loads it at get_seg_datasets.py:108-146):

    <root>/VOCdevkit/VOC2012/
        JPEGImages/<id>.jpg
        SegmentationClass/<id>.png        (P-mode palette label maps)
        ImageSets/Segmentation/{train,val,trainval}.txt

Split parity: the reference carves the official ``val`` list into 40% val /
60% test with ``torch.random_split`` under ``torch.manual_seed(42)``
(get_seg_datasets.py:111,133-136).  :func:`split_val_test` reproduces those
exact indices (torch CPU is available in this image; a numpy fallback keeps
the reader functional without torch, with a documented difference).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ee_semantic_segmentation_tpu_torch.data.transforms import SegTransform, TargetTransform

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


class VOCSegmentation:
    """Index-able (image, target) pairs for one image-set split."""

    def __init__(self, root: str, image_set: str = "train", year: str = "2012",
                 transform: SegTransform | None = None,
                 target_transform: TargetTransform | None = None):
        base = os.path.join(root, "VOCdevkit", f"VOC{year}")
        split_file = os.path.join(base, "ImageSets", "Segmentation", f"{image_set}.txt")
        if not os.path.exists(split_file):
            raise FileNotFoundError(
                f"VOC split list not found: {split_file} (dataset not downloaded; "
                "this image has no network egress — place VOCdevkit under "
                f"{root} manually)"
            )
        with open(split_file) as fh:
            ids = [line.strip() for line in fh if line.strip()]
        self.images = [os.path.join(base, "JPEGImages", f"{i}.jpg") for i in ids]
        self.targets = [os.path.join(base, "SegmentationClass", f"{i}.png") for i in ids]
        self.transform = transform
        self.target_transform = target_transform

    def __len__(self):
        return len(self.images)

    def get(self, idx: int, rng: np.random.Generator | None = None):
        img = Image.open(self.images[idx])
        tgt = Image.open(self.targets[idx])
        if self.transform:
            img = self.transform(img, rng)
        if self.target_transform:
            tgt = self.target_transform(tgt)
        return img, tgt

    __getitem__ = get


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def get(self, idx: int, rng=None):
        return self.dataset.get(self.indices[idx], rng)

    __getitem__ = get


def split_val_test(n: int, seed: int = 42, val_frac: float = 0.4):
    """Replicate torch ``random_split([val_size, test_size])`` under
    ``manual_seed(42)`` (get_seg_datasets.py:111,133-136) so val/test contain
    the same images as the reference."""
    val_size = int(val_frac * n)
    test_size = n - val_size
    try:
        import torch

        torch.manual_seed(seed)
        perm = torch.randperm(n).tolist()
    except ImportError:  # pragma: no cover - torch is present in this image
        perm = np.random.RandomState(seed).permutation(n).tolist()
    return perm[:val_size], perm[val_size : val_size + test_size]


def load_voc_seg(root: str, input_dim: int, target_dim: int | None = None, seed: int = 42):
    """train/val/test datasets with reference-matching transforms + split."""
    target_dim = target_dim or input_dim
    train = VOCSegmentation(
        root, "train",
        transform=SegTransform(input_dim, train=True),
        target_transform=TargetTransform(target_dim),
    )
    val_test = VOCSegmentation(
        root, "val",
        transform=SegTransform(input_dim, train=False),
        target_transform=TargetTransform(target_dim),
    )
    val_idx, test_idx = split_val_test(len(val_test), seed)
    return train, Subset(val_test, val_idx), Subset(val_test, test_idx)
