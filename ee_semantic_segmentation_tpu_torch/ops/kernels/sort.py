"""Per-row key-value sort: CUDA kernel wrapper and plain version (kernel D).

Port of ``ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py``
(``sort_pallas``).  The exact Lovász loss sorts every (exit, image or
batch, class) row of errors in its forward pass and unsorts the gradient
with a second sort in its backward pass (``ops/lovasz.py``);
``sort_rows`` is that sort:

* ``sort_rows(key, pay) -> (key_sorted, pay_sorted)``: a (B, P) float32 or
  int32 key tensor sorted ascending along each row, and a (B, P) 32-bit
  payload (float32 or int32, moved as raw bits) carried with its key.  The
  order within exactly tied keys is unspecified, as in the JAX kernel.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes
``sort_rows_plain`` (``torch.sort(stable=True)`` plus ``torch.gather``), a
CUDA tensor launches the bitonic network of ``csrc/sort_rows.cu`` or
raises.  Every P >= 1 takes the kernel: it pads each row to a power of two
with keys that sort last.  The pad key is the largest key in the kernel's
order, which only the int32 key 2^31 - 1 (and one NaN bit pattern, which
the kernel rewrites to a quiet NaN first) share; a ragged row holding the
int32 key 2^31 - 1 may carry a padding payload with it.

``sort_rows.launches`` counts the wrapper's kernel launches.
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.kernels import _build

_KEY_TYPES = (torch.float32, torch.int32)
_PAY_TYPES = (torch.float32, torch.int32)


def sort_rows_plain(key: torch.Tensor, pay: torch.Tensor):
    """Plain version of :func:`sort_rows`, any dtypes and devices."""
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    return key_sorted, torch.gather(pay, -1, order)


def _check(key: torch.Tensor, pay: torch.Tensor) -> None:
    if key.device.type != "cuda":
        raise ValueError(f"key on {key.device}: the kernel takes CUDA tensors")
    if key.dtype not in _KEY_TYPES or pay.dtype not in _PAY_TYPES:
        raise TypeError(f"keys must be float32 or int32 and payloads float32 or int32, "
                        f"got {key.dtype} and {pay.dtype}")
    if key.ndim != 2 or key.shape != pay.shape or pay.device != key.device:
        raise ValueError(f"key and payload must be (B, P) tensors of one shape on one device, "
                         f"got {tuple(key.shape)} on {key.device} and {tuple(pay.shape)} "
                         f"on {pay.device}")
    if not (key.is_contiguous() and pay.is_contiguous()):
        raise ValueError("key and payload must be contiguous")


def sort_rows(key: torch.Tensor, pay: torch.Tensor):
    """Sort each row of ``key`` ascending, carrying ``pay``.  Kernel D."""
    if key.device.type == "cpu":
        return sort_rows_plain(key, pay)
    _check(key, pay)
    B, P = key.shape
    key_out, pay_out = torch.empty_like(key), torch.empty_like(pay)
    if B == 0 or P == 0:
        return key_out, pay_out
    lib = _build.load_library()
    N = 1 << (P - 1).bit_length()
    scratch = None
    if N > 1 << lib.ee_sort_log2_tile():
        scratch = torch.empty((2, B, N), dtype=torch.int32, device=key.device)
    with torch.cuda.device(key.device):
        err = lib.ee_sort_rows(
            key.data_ptr(), pay.data_ptr(), int(key.dtype == torch.float32), B, P,
            key_out.data_ptr(), pay_out.data_ptr(),
            None if scratch is None else scratch[0].data_ptr(),
            None if scratch is None else scratch[1].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sort_rows")
    sort_rows.launches += 1
    return key_out, pay_out


sort_rows.launches = 0
KERNELS = (sort_rows,)
