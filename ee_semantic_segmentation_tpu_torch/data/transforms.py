"""Image/target transforms in numpy + PIL (host side, fixed output shapes).

Reproduces the reference pipeline (get_seg_datasets.py:49-86):

* train images: Resize(shorter side -> d) + CenterCrop(d) + ToTensor +
  RandomApply(p=.2){ColorJitter(.5,.5,.5,.25) | SaltAndPepper(amount=.01)} +
  Normalize(ImageNet mean/std),
* eval images: same without augmentation,
* targets: Resize + CenterCrop (PIL forces NEAREST for P-mode label PNGs) +
  integer labels with the VOC void remap 255 -> 21
  (get_seg_datasets.py:79-86).

Outputs are HWC float32 (image) and HW int32 (target) — channels-last for
TPU.  Randomness is an explicit ``numpy.random.Generator`` so the pipeline
is reproducible and per-host shardable.
"""

from __future__ import annotations

import numpy as np

try:  # PIL is available in this image; degrade gracefully for array inputs
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_pil(img, size: int, nearest: bool):
    """torchvision Resize(int): shorter side -> size, keep aspect."""
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    resample = Image.NEAREST if nearest else Image.BILINEAR
    return img.resize((nw, nh), resample)


def _center_crop_pil(img, size: int):
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    if w < size or h < size:  # torchvision pads when smaller
        canvas = Image.new(img.mode, (max(w, size), max(h, size)), 0)
        canvas.paste(img, ((max(w, size) - w) // 2, (max(h, size) - h) // 2))
        img = canvas
        w, h = img.size
        left = (w - size) // 2
        top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def resize_center_crop(img, size: int, nearest: bool = False):
    return _center_crop_pil(_resize_pil(img, size, nearest), size)


# ------------------------------------------------------------- augmentations
def _blend(a, b, ratio):
    return np.clip(ratio * a + (1.0 - ratio) * b, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img, factor):
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]).mean()
    return _blend(img, np.full_like(img, gray), factor)


def adjust_saturation(img, factor):
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return _blend(img, gray[..., None], factor)


def adjust_hue(img, factor):
    """Shift hue by ``factor`` (in turns, torchvision convention [-0.5, 0.5])."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1).astype(img.dtype)


def color_jitter(img, rng: np.random.Generator, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.25):
    """torchvision ColorJitter: the four ops in random order with uniform
    factors (brightness/contrast/saturation in [max(0,1-x), 1+x], hue in
    [-hue, hue])."""
    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x, f=f: adjust_brightness(x, f))
    if contrast:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x, f=f: adjust_contrast(x, f))
    if saturation:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda x, f=f: adjust_saturation(x, f))
    if hue:
        f = rng.uniform(-hue, hue)
        ops.append(lambda x, f=f: adjust_hue(x, f))
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return img


def salt_and_pepper(img, rng: np.random.Generator, amount=0.01, prop=0.5):
    """skimage random_noise(mode='s&p') semantics on a [0,1] float image
    (the reference's Salt_n_Pepper, get_seg_datasets.py:23-31): ``amount`` of
    pixels flipped, ``prop`` of those to salt (1.0), rest pepper (0.0)."""
    flip = rng.random(img.shape[:2]) < amount
    salted = rng.random(img.shape[:2]) < prop
    out = img.copy()
    out[flip & salted] = 1.0
    out[flip & ~salted] = 0.0
    return out


# ------------------------------------------------------------------ pipeline
class SegTransform:
    """Image pipeline: PIL/array -> float32 HWC, augmented + normalized."""

    def __init__(self, input_dim: int, train: bool = False, aug_prob: float = 0.2,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.input_dim = input_dim
        self.train = train
        self.aug_prob = aug_prob
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, rng: np.random.Generator | None = None):
        if Image is not None and isinstance(img, Image.Image):
            img = img.convert("RGB")
            img = resize_center_crop(img, self.input_dim)
            arr = np.asarray(img, np.float32) / 255.0
        else:
            arr = np.asarray(img, np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        if self.train and rng is not None and rng.random() < self.aug_prob:
            if rng.random() < 0.5:
                arr = color_jitter(arr, rng)
            else:
                arr = salt_and_pepper(arr, rng)
        return (arr - self.mean) / self.std


class TargetTransform:
    """Label pipeline: PIL P-mode/array -> int32 HW with 255 -> void remap."""

    def __init__(self, target_dim: int, void_from: int = 255, void_to: int = 21):
        self.target_dim = target_dim
        self.void_from = void_from
        self.void_to = void_to

    def __call__(self, tgt):
        if Image is not None and isinstance(tgt, Image.Image):
            tgt = resize_center_crop(tgt, self.target_dim, nearest=True)
            arr = np.asarray(tgt, np.int32)
        else:
            arr = np.asarray(tgt, np.int32)
        return np.where(arr == self.void_from, self.void_to, arr).astype(np.int32)
