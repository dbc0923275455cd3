"""Cityscapes semantic segmentation reader (19 train classes + void).

The reference only wires VOC (its ``LoadDataset`` dispatches by method name,
get_seg_datasets.py:148-158), but the benchmark
configs include Cityscapes 1024x512 and 2048x1024 training
(BASELINE.json:9-10), so the framework ships a native reader for the
standard layout:

    <root>/leftImg8bit/{train,val,test}/<city>/*_leftImg8bit.png
    <root>/gtFine/{train,val,test}/<city>/*_gtFine_labelIds.png

Raw ``labelIds`` are remapped to the canonical 19 train ids; everything else
becomes the void class ``19`` (so ``ignore_index=19`` / ``n_classes=19``
plays the role VOC's 21/22 does).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ee_semantic_segmentation_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

# labelId -> trainId (the standard Cityscapes mapping); unlisted ids -> void
_TRAIN_IDS = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
NUM_CLASSES = 19
VOID = 19

_LUT = np.full(256, VOID, np.int32)
for k, v in _TRAIN_IDS.items():
    _LUT[k] = v


def label_to_train_ids(label: np.ndarray) -> np.ndarray:
    return _LUT[label.astype(np.int64)]


class CityscapesSegmentation:
    """Index-able (image, target) pairs for one split, fixed (h, w) output."""

    def __init__(self, root: str, split: str = "train", size: tuple[int, int] = (512, 1024),
                 train: bool = False, aug_prob: float = 0.2):
        self.size = size  # (H, W)
        self.train = train
        self.aug_prob = aug_prob
        img_glob = os.path.join(root, "leftImg8bit", split, "*", "*_leftImg8bit.png")
        self.images = sorted(glob.glob(img_glob))
        if not self.images:
            raise FileNotFoundError(
                f"no Cityscapes images under {img_glob} (dataset not present; "
                "no network egress in this image — place it manually)"
            )
        self.targets = [
            p.replace("leftImg8bit", "gtFine").replace("_gtFine.png", "_gtFine_labelIds.png")
            for p in (q.replace("_leftImg8bit.png", "_gtFine.png") for q in self.images)
        ]

    def __len__(self):
        return len(self.images)

    def get(self, idx: int, rng: np.random.Generator | None = None):
        from ee_semantic_segmentation_tpu_torch.data import transforms as T

        h, w = self.size
        img = Image.open(self.images[idx]).convert("RGB").resize((w, h), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        if self.train and rng is not None and rng.random() < self.aug_prob:
            if rng.random() < 0.5:
                arr = T.color_jitter(arr, rng)
            else:
                arr = T.salt_and_pepper(arr, rng)
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD

        tgt = Image.open(self.targets[idx]).resize((w, h), Image.NEAREST)
        lab = label_to_train_ids(np.asarray(tgt))
        return arr.astype(np.float32), lab

    __getitem__ = get


def load_cityscapes(root: str, size=(512, 1024)):
    """train/val dataset pair with standard transforms."""
    return (
        CityscapesSegmentation(root, "train", size, train=True),
        CityscapesSegmentation(root, "val", size, train=False),
    )


def load_cityscapes_seg(root: str, input_dim, seed: int = 42):
    """train/val/test trio mirroring the VOC facade (voc.load_voc_seg).

    Cityscapes' official ``test`` split has no public labels, so — like the
    reference carves VOC's official val into 40% val / 60% test
    (get_seg_datasets.py:133-136) — the official ``val``
    split is carved with the same seeded 40/60 rule."""
    from ee_semantic_segmentation_tpu_torch.data.voc import Subset, split_val_test

    size = (input_dim, input_dim) if isinstance(input_dim, int) else tuple(input_dim)
    train = CityscapesSegmentation(root, "train", size, train=True)
    val_test = CityscapesSegmentation(root, "val", size, train=False)
    val_idx, test_idx = split_val_test(len(val_test), seed)
    return train, Subset(val_test, val_idx), Subset(val_test, test_idx)
