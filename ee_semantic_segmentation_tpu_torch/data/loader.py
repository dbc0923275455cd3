"""Batching + background prefetch, and the reference-compatible LoadDataset.

The reference uses torch ``DataLoader`` worker processes
(main_bradeepv3.py:81-85, deepv3_funcs.py:159-162).  Here a
thread-pool prefetcher assembles statically shaped numpy batches while the
device computes.  Every batch has an identical shape (remainder batches are
padded and carry a validity count), so the evaluators never see a ragged
batch.

``LoadDataset`` mirrors the reference's facade
(get_seg_datasets.py:33-158): ``LoadDataset(input_dim, target_dim,
bs_train, bs_test, seed).get_dataset(path, 'voc_seg')`` returns train/val/
test datasets (or loaders when batch sizes are given).
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Iterator

import numpy as np


class Batch(dict):
    """dict with attribute access: image (N,H,W,C), label (N,H,W), count."""

    __getattr__ = dict.__getitem__


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, pad_final: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2,
                 shard_by_process: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        if shard_by_process:
            raise NotImplementedError(
                "shard_by_process: multi-process input sharding is not ported "
                "yet (ROADMAP.md queue A, multi-GPU)")

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1_000_003 + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        return idx

    def __iter__(self) -> Iterator[Batch]:
        idx = self._indices()
        self.epoch += 1
        bs = self.batch_size
        batches = [idx[i : i + bs] for i in range(0, len(idx), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()

        base_seed = self.seed * 7_654_321 + self.epoch

        def load_one(args):
            slot, ds_index = args
            rng = np.random.default_rng(base_seed + int(ds_index))
            return slot, self.dataset.get(int(ds_index), rng)

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            window: list = []

            def assemble(batch_ids):
                items = list(pool.map(load_one, enumerate(batch_ids)))
                items.sort(key=lambda kv: kv[0])
                imgs = np.stack([im for _, (im, _) in items])
                labs = np.stack([lb for _, (_, lb) in items])
                count = len(batch_ids)
                if self.pad_final and count < bs:
                    pad = bs - count
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
                    labs = np.concatenate([labs, np.repeat(labs[-1:], pad, 0)])
                return Batch(image=imgs, label=labs, count=count)

            it = iter(batches)
            try:
                for _ in range(self.prefetch):
                    window.append(pool.submit(assemble, next(it)))
            except StopIteration:
                pass
            while window:
                fut = window.pop(0)
                try:
                    window.append(pool.submit(assemble, next(it)))
                except StopIteration:
                    pass
                yield fut.result()


# dataset name -> (n_classes incl. background, void/ignore label)
# voc_seg: 21 classes, 255 remapped to void=21 (get_seg_datasets.py:79-86);
# cityscapes: 19 train ids, everything else void=19 (data/cityscapes.py).
DATASET_CLASSES = {
    "voc_seg": (21, 21),
    "synthetic": (21, 21),
    "cityscapes": (19, 19),
}


def dataset_class_info(name: str) -> tuple[int, int]:
    """(num_classes, void_index) for a dataset name; VOC-shaped default."""
    return DATASET_CLASSES.get(name, (21, 21))


class LoadDataset:
    """Reference-facade (get_seg_datasets.py:33-158): dataset dispatch by
    string name; ``voc_seg`` builds the VOC train/val/test trio."""

    def __init__(self, input_dim, target_dim=None, batch_size_train=None,
                 batch_size_test=None, seed: int = 42):
        # int -> square; (H, W) -> non-square (Cityscapes 512x1024 etc.)
        if isinstance(input_dim, (tuple, list)):
            dims = tuple(int(d) for d in input_dim)
            input_dim = dims[0] if len(dims) == 1 or dims[0] == dims[1] else dims
        else:
            input_dim = int(input_dim)
        self.input_dim = input_dim
        self.target_dim = target_dim
        self.batch_size_train = batch_size_train
        self.batch_size_test = batch_size_test
        self.seed = seed

    def _loaders(self, train, val, test):
        if not self.batch_size_train:
            return train, val, test
        return (
            DataLoader(train, self.batch_size_train, shuffle=True, seed=self.seed),
            DataLoader(val, self.batch_size_test),
            DataLoader(test, self.batch_size_test),
        )

    def voc_seg(self, root_path):
        from ee_semantic_segmentation_tpu_torch.data.voc import load_voc_seg

        dim = self.input_dim if isinstance(self.input_dim, int) else self.input_dim[0]
        return self._loaders(*load_voc_seg(root_path, dim, self.target_dim, self.seed))

    def cityscapes(self, root_path):
        """Cityscapes trio (19 train classes, void=19); benchmark configs #3/#4."""
        from ee_semantic_segmentation_tpu_torch.data.cityscapes import load_cityscapes_seg

        return self._loaders(*load_cityscapes_seg(root_path, self.input_dim, self.seed))

    def synthetic(self, root_path=None):
        from ee_semantic_segmentation_tpu_torch.data.synthetic import SyntheticSegDataset

        mk = lambda seed, n: SyntheticSegDataset(size=self.input_dim, n=n, seed=seed)
        return self._loaders(mk(0, 64), mk(1, 16), mk(2, 16))

    def get_dataset(self, root_path, dataset_name):
        fn = getattr(self, dataset_name, None)
        if fn is None:
            raise ValueError(f"No dataset {dataset_name} is found")
        return fn(root_path)
