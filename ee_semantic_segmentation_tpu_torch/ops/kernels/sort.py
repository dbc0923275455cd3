"""Per-row key-value sort and its inverse permutation scatter: CUDA kernel
wrappers and plain versions (kernel D and its backward call).

Port of ``ee_semantic_segmentation_tpu/ops/pallas/sort_kernel.py``
(``sort_pallas``).  The exact Lovász loss sorts every (exit, image or
batch, class) row of errors in its forward pass and puts the gradient back
in pixel order in its backward pass (``ops/lovasz.py``):

* ``sort_rows(key, pay) -> (key_sorted, pay_sorted)``: a (B, P) float32 or
  int32 key tensor sorted ascending and stably along each row, and a (B, P)
  32-bit payload (float32 or int32, moved as raw bits) carried with its
  key.  Keys move as raw bits too; -0.0 ties with +0.0 and every NaN sorts
  last, as in ``torch.sort`` on the CPU, numpy and ``jax.lax.sort`` (on
  CUDA, ``torch.sort`` puts a NaN whose sign bit is set first).  The result
  equals ``sort_rows_plain`` on the CPU bit for bit, keys and payloads.
* ``unsort_rows(perm, vals) -> out``: ``out[r, perm[r, i]] = vals[r, i]``
  for a (B, P) int32 ``perm`` whose every row is a permutation of
  0..P - 1 and (B, P) 32-bit ``vals`` (moved as raw bits).  Under that
  contract it equals ``sort_rows(perm, vals)[1]``, the JAX package's
  unsort-by-sort, bit for bit.  The contract is not checked (that would
  cost a pass): on CUDA an index outside [0, P) is dropped, a slot that no
  index names holds an unspecified value, and nothing is written outside
  the output.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version (``sort_rows_plain``: ``torch.sort(stable=True)`` plus
``torch.gather``; ``unsort_rows_plain``: one ``scatter_``), a CUDA tensor
launches the kernels of ``csrc/sort_rows.cu`` (a stable LSD radix sort;
a two-pass scatter through a staging copy bucketed by the destination's
window, or for rows of more than 4096 windows a one-pass scatter) or
raises.  Every P >= 1 takes the kernels.

Each wrapper counts its calls that launch in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.kernels import _build

_KEY_TYPES = (torch.float32, torch.int32)
_PAY_TYPES = (torch.float32, torch.int32)
_MAX_P = (1 << 31) - 1  # row offsets are int32 inside the kernels


def sort_rows_plain(key: torch.Tensor, pay: torch.Tensor):
    """Plain version of :func:`sort_rows`, any dtypes and devices."""
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    return key_sorted, torch.gather(pay, -1, order)


def unsort_rows_plain(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`unsort_rows`, any dtypes and devices."""
    return torch.empty_like(vals).scatter_(-1, perm.long(), vals)


def unsort_window() -> int:
    """Elements of a window of the two-pass unsort: a row of more than
    4096 windows takes the one-pass scatter."""
    return _build.load_library().ee_unsort_window()


def _check(key: torch.Tensor, pay: torch.Tensor, key_types=_KEY_TYPES) -> None:
    if key.device.type != "cuda":
        raise ValueError(f"key on {key.device}: the kernel takes CUDA tensors")
    if key.dtype not in key_types or pay.dtype not in _PAY_TYPES:
        raise TypeError(f"keys must be {' or '.join(map(str, key_types))} and payloads "
                        f"float32 or int32, got {key.dtype} and {pay.dtype}")
    if key.ndim != 2 or key.shape != pay.shape or pay.device != key.device:
        raise ValueError(f"key and payload must be (B, P) tensors of one shape on one device, "
                         f"got {tuple(key.shape)} on {key.device} and {tuple(pay.shape)} "
                         f"on {pay.device}")
    if not (key.is_contiguous() and pay.is_contiguous()):
        raise ValueError("key and payload must be contiguous")
    if key.shape[1] > _MAX_P:
        raise ValueError(f"rows of {key.shape[1]} elements: the kernels take P < 2^31")


def sort_rows(key: torch.Tensor, pay: torch.Tensor):
    """Sort each row of ``key`` ascending and stably, carrying ``pay``.
    Kernel D."""
    if key.device.type == "cpu":
        return sort_rows_plain(key, pay)
    _check(key, pay)
    B, P = key.shape
    key_out, pay_out = torch.empty_like(key), torch.empty_like(pay)
    if B == 0 or P == 0:
        return key_out, pay_out
    lib = _build.load_library()
    scratch = torch.empty((2, B, P), dtype=torch.int32, device=key.device)
    aux = torch.empty(lib.ee_sort_aux_words(B, P), dtype=torch.int32, device=key.device)
    with torch.cuda.device(key.device):
        err = lib.ee_sort_rows(
            key.data_ptr(), pay.data_ptr(), int(key.dtype == torch.float32), B, P,
            key_out.data_ptr(), pay_out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            aux.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sort_rows")
    sort_rows.launches += 1
    return key_out, pay_out


def unsort_rows(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[r, perm[r, i]] = vals[r, i]`` for rows of ``perm`` that are
    permutations of 0..P - 1 (not checked).  Kernel D's backward call."""
    if perm.device.type == "cpu":
        return unsort_rows_plain(perm, vals)
    _check(perm, vals, key_types=(torch.int32,))
    B, P = perm.shape
    out = torch.empty_like(vals)
    if B == 0 or P == 0:
        return out
    lib = _build.load_library()
    scratch = torch.empty(lib.ee_unsort_scratch_words(B, P), dtype=torch.int32,
                          device=perm.device)
    with torch.cuda.device(perm.device):
        err = lib.ee_unsort_rows(perm.data_ptr(), vals.data_ptr(), B, P, out.data_ptr(),
                                 scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "unsort_rows")
    unsort_rows.launches += 1
    return out


sort_rows.launches = 0
unsort_rows.launches = 0
KERNELS = (sort_rows, unsort_rows)
