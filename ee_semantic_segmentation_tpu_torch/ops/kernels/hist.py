"""Error-bucket histograms and table lookup: CUDA kernel wrappers and plain
versions (kernels E and F).

Port of ``ee_semantic_segmentation_tpu/ops/pallas/hist_kernel.py``.  The
sort-free histogram Lovász (``ops/lovasz.py``, the training CLI's ``-G``)
buckets each row's errors into ``bins`` uniform-width descending buckets:

* ``hist2d_weighted(errors, fg, emax, inv_w, bins=...) -> (rows, 4, bins)``
  float32: per bucket, the pixel count, the foreground count, the error sum
  and the foreground error sum (kernel E, the loss's forward);
* ``table_lookup(errors, fg, emax, inv_w, tables, bins=...) -> (rows, P)``
  float32: per pixel, its row's ``tables[row, 0 if fg else 1, bucket]``,
  0 on void pixels (kernel F, the backward).

``errors`` is (rows, P) with void pixels at -1e30 (any error <= -1e29 is
void); ``fg`` is a (rows, P) bool foreground mask; ``emax`` and ``inv_w``
are per row, and a pixel's bucket is ``trunc(clip((emax - e) * inv_w, 0,
bins - 1))``.  ``bins`` is 128 times a power of two (``hist_bins_ok``), as
in the JAX package, with no upper limit: the CUDA kernels take every such
count (kernel E keeps ``range_bins()`` = 8192 buckets a block and takes
more in ranges of that many; kernel F stages a row's table in shared memory
up to 16384 buckets and reads it from L2 above).  Up to 2^30 buckets they
run; above, one row's output and scratch alone (48 bytes a bucket) exceed
an H100's 80 GB and ``torch.empty`` raises first.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version (``*_plain``: one ``scatter_add_`` per histogram, one
``gather``), a CUDA tensor launches the kernels of ``csrc/hist_lovasz.cu``
or raises.  The kernels take float32 errors.

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ee_semantic_segmentation_tpu_torch.ops.kernels import _build

_LANES = 128
_VALID_THRESH = -1e29  # void slots carry -1e30


def hist_bins_ok(bins: int) -> bool:
    """Supported bucket counts: bins = B1 * 128 with B1 a power of two."""
    b1 = bins // _LANES
    return bins % _LANES == 0 and b1 >= 1 and (b1 & (b1 - 1)) == 0


def _check_bins(bins: int) -> None:
    if not hist_bins_ok(bins):
        raise ValueError(
            f"hist bins must be 128 * a power of two (got {bins}); see hist_bins_ok()")


def _bucket_ids(errors, emax, inv_w, bins: int) -> torch.Tensor:
    """Descending bucket index (0 = the largest error) of every pixel."""
    t = ((emax[:, None] - errors) * inv_w[:, None]).clamp(0.0, float(bins - 1))
    return t.to(torch.int64)


def range_bins() -> int:
    """The most buckets one block of kernel E keeps in shared memory (24
    bytes a bucket); above it, E takes the buckets in ranges of this many."""
    return _build.load_library().ee_hist_range_bins()


def hist2d_weighted_plain(errors, fg, emax, inv_w, *, bins: int) -> torch.Tensor:
    """Plain version of :func:`hist2d_weighted`, any float dtype and device."""
    _check_bins(bins)
    valid = errors > _VALID_THRESH
    fgv = fg & valid
    idx = _bucket_ids(errors, emax, inv_w, bins)
    weights = (valid, fgv, errors * valid, errors * fgv)
    out = torch.zeros((4, errors.shape[0], bins), dtype=torch.float32, device=errors.device)
    for k, wk in enumerate(weights):
        out[k].scatter_add_(1, idx, wk.to(torch.float32))
    return out.permute(1, 0, 2).contiguous()


def table_lookup_plain(errors, fg, emax, inv_w, tables, *, bins: int) -> torch.Tensor:
    """Plain version of :func:`table_lookup`, any float dtype and device."""
    _check_bins(bins)
    valid = (errors > _VALID_THRESH).to(tables.dtype)
    idx = _bucket_ids(errors, emax, inv_w, bins)
    w = torch.where(fg, tables[:, 0].gather(1, idx), tables[:, 1].gather(1, idx))
    return w * valid


def _check(errors, fg, emax, inv_w, bins: int, tables=None) -> None:
    if errors.device.type != "cuda":
        raise ValueError(f"errors on {errors.device}: the kernels take CUDA tensors")
    if errors.ndim != 2:
        raise ValueError(f"errors must be (rows, P), got {tuple(errors.shape)}")
    rows = errors.shape[0]
    want = {"errors": (errors, tuple(errors.shape), torch.float32),
            "fg": (fg, tuple(errors.shape), torch.bool),
            "emax": (emax, (rows,), torch.float32), "inv_w": (inv_w, (rows,), torch.float32)}
    if tables is not None:
        want["tables"] = (tables, (rows, 2, bins), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != errors.device or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {shape} tensor on {errors.device}, "
                             f"got {tuple(t.shape)} on {t.device}")


def _hist_chunk(bins: int) -> int:
    """Pixels a block of kernel E: enough that a block's share of the row
    outweighs the atomics it adds to the row's totals once per bucket, for
    the at most ``range_bins()`` buckets a block keeps."""
    return max(1 << 16, 64 * min(bins, range_bins()))


def hist2d_weighted(errors: torch.Tensor, fg: torch.Tensor, emax: torch.Tensor,
                    inv_w: torch.Tensor, *, bins: int) -> torch.Tensor:
    """(rows, P) errors and fg, per-row (emax, inv_w) -> (rows, 4, bins)
    float32 [count, fg count, error sum, fg error sum] per descending
    bucket.  Kernel E."""
    _check_bins(bins)
    if errors.device.type == "cpu":
        return hist2d_weighted_plain(errors, fg, emax, inv_w, bins=bins)
    _check(errors, fg, emax, inv_w, bins)
    rows, P = errors.shape
    if rows == 0 or P == 0:
        return torch.zeros((rows, 4, bins), dtype=torch.float32, device=errors.device)
    out = torch.empty((rows, 4, bins), dtype=torch.float32, device=errors.device)
    lib = _build.load_library()
    scratch = torch.empty(lib.ee_hist_scratch_words(rows, bins), dtype=torch.int32,
                          device=errors.device)
    with torch.cuda.device(errors.device):
        err = lib.ee_hist2d_weighted(
            errors.data_ptr(), fg.data_ptr(), emax.data_ptr(), inv_w.data_ptr(), rows, P, bins,
            _hist_chunk(bins), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "hist2d_weighted")
    hist2d_weighted.launches += 1
    return out


def table_lookup(errors: torch.Tensor, fg: torch.Tensor, emax: torch.Tensor,
                 inv_w: torch.Tensor, tables: torch.Tensor, *, bins: int) -> torch.Tensor:
    """(rows, P) errors and fg, per-row (emax, inv_w), (rows, 2, bins)
    [fg, bg] tables -> (rows, P) float32 per-pixel weights, 0 on void.
    Kernel F."""
    _check_bins(bins)
    if errors.device.type == "cpu":
        return table_lookup_plain(errors, fg, emax, inv_w, tables, bins=bins)
    _check(errors, fg, emax, inv_w, bins, tables)
    rows, P = errors.shape
    out = torch.empty((rows, P), dtype=torch.float32, device=errors.device)
    if rows == 0 or P == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(errors.device):
        err = lib.ee_table_lookup(
            errors.data_ptr(), fg.data_ptr(), emax.data_ptr(), inv_w.data_ptr(),
            tables.data_ptr(), rows, P, bins, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "table_lookup")
    table_lookup.launches += 1
    return out


hist2d_weighted.launches = 0
table_lookup.launches = 0
KERNELS = (hist2d_weighted, table_lookup)
