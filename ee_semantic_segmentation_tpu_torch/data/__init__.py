"""Host-side input pipeline: decode/augment in numpy/PIL, fixed shapes out.

Mirrors the reference's torchvision pipeline (get_seg_datasets.py):
Resize -> CenterCrop -> normalize, p=0.2 {color jitter | salt & pepper}
train augmentation, target label maps with the VOC void remap 255 -> 21.  Batches come out as statically shaped numpy arrays that the
evaluators copy to the device; a background-thread prefetcher overlaps host
decode with device compute.

This is the PyTorch port's copy of ``ee_semantic_segmentation_tpu.data``
(numpy/PIL only), kept separate so the port never imports the JAX package.
"""

from ee_semantic_segmentation_tpu_torch.data.transforms import (
    SegTransform,
    TargetTransform,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from ee_semantic_segmentation_tpu_torch.data.voc import VOCSegmentation, load_voc_seg
from ee_semantic_segmentation_tpu_torch.data.synthetic import SyntheticSegDataset
from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader, LoadDataset
