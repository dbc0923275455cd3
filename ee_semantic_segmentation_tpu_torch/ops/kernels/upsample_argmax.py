"""Fused bilinear-upsample eval heads: CUDA kernel wrappers and plain versions.

Port of ``ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py``.  The
eval paths upsample every exit's low-res logits to input resolution only to
argmax them (and, for the entropy gate, to take the softmax entropy).  The
three hand-written CUDA kernels in ``csrc/upsample_heads.cu`` stage each
band of output rows' row interpolation in shared memory and take each
output pixel's column step from there, so the upsampled (N, H, W, C)
float32 tensor never exists:

* ``upsample_argmax_confusion`` -> (3, C) TP/FP/FN of the argmax map
  against the labels, over rows ``n < count`` (kernel A);
* ``upsample_entropy_argmax`` -> the (N, H, W) argmax map and the (N,)
  per-image mean normalized entropy (kernel B);
* ``upsample_argmax`` -> the (N, H, W) argmax map alone, for the
  similarity gates (kernel C).

Each wrapper calls a PyTorch custom operator (``ee_seg::<wrapper name>``),
so ``torch.export`` can trace a caller through it.  Dispatch is by the
tensor's device and nothing else: on a CPU tensor the operator runs the
plain version (``*_plain``), on a CUDA tensor it launches the kernel or
raises.
The plain versions run the separable weight-matrix product in float32 (the
math of the JAX package's ``_confusion_tiled_xla``), then argmax, then the
bincount confusion or the softmax entropy of ``ops/gating.py``; the tests
and ``chip_smoke.py`` hold the kernels against them.

Each wrapper counts its launches in ``<wrapper>.launches``: the operator's
CUDA implementation adds one where it launches, also when an exported
program calls it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ee_semantic_segmentation_tpu_torch.ops.gating import pixel_entropy
from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
from ee_semantic_segmentation_tpu_torch.ops.metrics import confusion_update


@functools.lru_cache(maxsize=64)
def _resize_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Exact 1-D bilinear upsampling weight matrix (n_out, n_in).

    Replicates jax.image.resize(method='bilinear') for n_out >= n_in
    (no antialias in the upsampling regime): half-pixel sample centers,
    triangle kernel, out-of-range taps dropped and rows renormalized.
    """
    assert n_out >= n_in, "upsampling only (antialias changes downsampling)"
    scale = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    d = sample[:, None] - np.arange(n_in)[None, :]
    w = np.maximum(0.0, 1.0 - np.abs(d))
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _taps_np(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Each output index's two taps of ``_resize_matrix_np``: (n_out, 2)
    int32 indices (i0, i1) and (n_out, 2) float32 weights (w0, w1).  A row
    with one nonzero gets i1 = i0, w1 = 0."""
    m = _resize_matrix_np(n_in, n_out)
    nz = m > 0
    n_nz = nz.sum(axis=1)
    i0 = nz.argmax(axis=1)
    i1 = i0 + n_nz - 1
    rows = np.arange(n_out)
    if n_nz.max() > 2 or not np.all(nz[rows, i1]):
        raise ValueError(f"resize {n_in}->{n_out} is not a two-tap bilinear upsample")
    idx = np.stack([i0, i1], axis=1).astype(np.int32)
    w = np.stack([m[rows, i0], np.where(n_nz == 2, m[rows, i1], 0.0)], axis=1)
    return idx, w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_taps(n_in: int, n_out: int, device: torch.device):
    idx, w = _taps_np(n_in, n_out)
    return torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def _upsample_plain(logits: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, h, w, C) -> (N, H, W, C) float32 via ``Wh @ X_c @ Ww^T``."""
    _, h, w, _ = logits.shape
    H, W = out_hw
    wh = torch.from_numpy(_resize_matrix_np(h, H)).to(logits.device)
    ww = torch.from_numpy(_resize_matrix_np(w, W)).to(logits.device)
    t1 = torch.einsum("Hh,nhwc->nHwc", wh, logits.float())
    return torch.einsum("nHwc,Ww->nHWc", t1, ww)


def upsample_argmax_confusion_plain(logits, labels, count: int, out_hw) -> torch.Tensor:
    """Plain version of :func:`upsample_argmax_confusion`."""
    pred = _upsample_plain(logits, out_hw).argmax(dim=-1)
    return confusion_update(pred[:count], labels[:count], logits.shape[-1]).float()


def upsample_entropy_argmax_plain(logits, out_hw):
    """Plain version of :func:`upsample_entropy_argmax`."""
    C = logits.shape[-1]
    up = _upsample_plain(logits, out_hw)
    ent = pixel_entropy(torch.softmax(up, dim=-1), C).mean(dim=(1, 2))
    return up.argmax(dim=-1).int(), ent


def upsample_argmax_plain(logits, out_hw):
    """Plain version of :func:`upsample_argmax`."""
    return _upsample_plain(logits, out_hw).argmax(dim=-1).int()


def _check_logits(logits: torch.Tensor, out_hw) -> tuple[int, ...]:
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.ndim != 4 or not logits.is_contiguous():
        raise ValueError(f"logits must be a contiguous (N, h, w, C) tensor, got "
                         f"shape {tuple(logits.shape)}, strides {logits.stride()}")
    N, h, w, C = logits.shape
    H, W = (int(d) for d in out_hw)
    if H < h or W < w:
        raise ValueError(f"upsampling only: ({h}, {w}) -> ({H}, {W})")
    return N, h, w, C, H, W


def _check_device(logits: torch.Tensor) -> None:
    """The operators run on CPU tensors (plain versions) and CUDA tensors
    (kernels); any other device would reach only their fake versions."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"logits on {logits.device}: the kernels take CUDA tensors "
                         "(CPU tensors take the plain versions)")


def _launch_args(logits, H, W):
    """Common leading arguments: logits pointer, dtype flag, tap tables."""
    _, h, w, _ = logits.shape
    ri, rw = _device_taps(h, H, logits.device)
    ci, cw = _device_taps(w, W, logits.device)
    return (logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            ri.data_ptr(), rw.data_ptr(), ci.data_ptr(), cw.data_ptr())


def _band_tiles(lib, what: str, h: int, w: int, C: int, H: int, W: int) -> int:
    """Blocks an image of kernels B's and C's staged walk; raises where not
    even a band of one output row fits a block's shared memory (above
    ~9,700 classes)."""
    tiles = lib.ee_ent_partials_per_image(h, w, C, H, W)
    if tiles == 0:
        raise ValueError(f"{what}: a band of ({h}, {w}, {C}) -> ({H}, {W}) does not fit a "
                         "block's shared memory")
    return tiles


def upsample_argmax_confusion(logits: torch.Tensor, labels: torch.Tensor,
                              count: int, out_hw) -> torch.Tensor:
    """(N, h, w, C) logits + (N, H, W) int32 labels -> (3, C) float32
    summed TP/FP/FN of ``argmax(bilinear_upsample(logits))`` against the
    labels over rows ``n < count``.  Labels outside ``[0, C)`` are void:
    FP for the predicted class, nothing else.  Kernel A."""
    _check_device(logits)
    count = max(0, min(int(count), logits.shape[0]))
    H, W = (int(d) for d in out_hw)
    return torch.ops.ee_seg.upsample_argmax_confusion(logits, labels, count, H, W)


def upsample_entropy_argmax(logits: torch.Tensor, out_hw):
    """(N, h, w, C) logits -> ((N, H, W) int32 argmax of the bilinear
    upsample, (N,) float32 mean over pixels of the softmax entropy / log C).
    Kernel B."""
    C = logits.shape[-1]
    if C < 2:
        raise ValueError(
            f"normalized entropy needs n_classes >= 2 (base-C log), got C={C}")
    _check_device(logits)
    H, W = (int(d) for d in out_hw)
    return torch.ops.ee_seg.upsample_entropy_argmax(logits, H, W)


def upsample_argmax(logits: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, h, w, C) logits -> (N, H, W) int32 argmax of the bilinear
    upsample.  Kernel C.  With ``(H, W) == (h, w)`` there is nothing to
    upsample and the result is the argmax itself, as in the JAX package.
    On the card a ``ValueError`` where no band fits shared memory (above
    ~9,700 classes)."""
    if tuple(int(d) for d in out_hw) == tuple(logits.shape[1:3]):
        return logits.argmax(dim=-1).int()
    _check_device(logits)
    H, W = (int(d) for d in out_hw)
    return torch.ops.ee_seg.upsample_argmax(logits, H, W)


# ------------------------------------------------------------ custom operators
# Each kernel is the PyTorch custom operator ``ee_seg::<wrapper name>``.  Its
# CPU implementation is the plain version, its CUDA one launches the kernel
# or raises, and its fake one gives the output shapes and types, so that
# ``torch.export`` traces a caller through it (``ee/aot.py``) and the
# exported program calls the operator.  A process that loads such a program
# imports this module first, which registers the operators.

@torch.library.custom_op(
    "ee_seg::upsample_argmax_confusion", mutates_args=(), device_types="cpu",
    schema="(Tensor logits, Tensor labels, int count, int H, int W) -> Tensor")
def _confusion_op(logits, labels, count, H, W):
    return upsample_argmax_confusion_plain(logits, labels, count, (H, W))


@_confusion_op.register_kernel("cuda")
def _confusion_cuda(logits, labels, count, H, W):
    N, h, w, C, H, W = _check_logits(logits, (H, W))
    if labels.device != logits.device or labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32 on {logits.device}, got "
                        f"{labels.dtype} on {labels.device}")
    if tuple(labels.shape) != (N, H, W) or not labels.is_contiguous():
        raise ValueError(f"labels must be a contiguous {(N, H, W)} tensor, got "
                         f"{tuple(labels.shape)}")
    counts = torch.zeros((3, C), dtype=torch.int32, device=logits.device)
    if count == 0:
        return counts.float()
    lib = _build.load_library()
    with torch.cuda.device(logits.device):
        err = lib.ee_upsample_argmax_confusion(
            *_launch_args(logits, H, W), labels.data_ptr(), count, h, w, C, H, W,
            counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample_argmax_confusion")
    upsample_argmax_confusion.launches += 1
    return counts.float()


@_confusion_op.register_fake
def _confusion_fake(logits, labels, count, H, W):
    return logits.new_empty((3, logits.shape[-1]), dtype=torch.float32)


@torch.library.custom_op(
    "ee_seg::upsample_entropy_argmax", mutates_args=(), device_types="cpu",
    schema="(Tensor logits, int H, int W) -> (Tensor, Tensor)")
def _entropy_op(logits, H, W):
    return upsample_entropy_argmax_plain(logits, (H, W))


@_entropy_op.register_kernel("cuda")
def _entropy_cuda(logits, H, W):
    N, h, w, C, H, W = _check_logits(logits, (H, W))
    lib = _build.load_library()
    tiles = _band_tiles(lib, "upsample_entropy_argmax", h, w, C, H, W)  # an entropy partial a block
    labels = torch.empty((N, H, W), dtype=torch.int32, device=logits.device)
    partial = torch.empty((N, tiles), dtype=torch.float32, device=logits.device)
    ent = torch.empty((N,), dtype=torch.float32, device=logits.device)
    inv_norm = 1.0 / (H * W * math.log(C))
    with torch.cuda.device(logits.device):
        err = lib.ee_upsample_entropy_argmax(
            *_launch_args(logits, H, W), N, h, w, C, H, W, inv_norm,
            labels.data_ptr(), partial.data_ptr(), ent.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample_entropy_argmax")
    upsample_entropy_argmax.launches += 1
    return labels, ent


@_entropy_op.register_fake
def _entropy_fake(logits, H, W):
    N = logits.shape[0]
    return (logits.new_empty((N, H, W), dtype=torch.int32),
            logits.new_empty((N,), dtype=torch.float32))


@torch.library.custom_op(
    "ee_seg::upsample_argmax", mutates_args=(), device_types="cpu",
    schema="(Tensor logits, int H, int W) -> Tensor")
def _argmax_op(logits, H, W):
    return upsample_argmax_plain(logits, (H, W))


@_argmax_op.register_kernel("cuda")
def _argmax_cuda(logits, H, W):
    N, h, w, C, H, W = _check_logits(logits, (H, W))
    lib = _build.load_library()
    _band_tiles(lib, "upsample_argmax", h, w, C, H, W)
    labels = torch.empty((N, H, W), dtype=torch.int32, device=logits.device)
    if N == 0:
        return labels
    with torch.cuda.device(logits.device):
        err = lib.ee_upsample_argmax(
            *_launch_args(logits, H, W), N, h, w, C, H, W, labels.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "upsample_argmax")
    upsample_argmax.launches += 1
    return labels


@_argmax_op.register_fake
def _argmax_fake(logits, H, W):
    return logits.new_empty((logits.shape[0], H, W), dtype=torch.int32)


upsample_argmax_confusion.launches = 0
upsample_entropy_argmax.launches = 0
upsample_argmax.launches = 0
KERNELS = (upsample_argmax_confusion, upsample_entropy_argmax, upsample_argmax)
