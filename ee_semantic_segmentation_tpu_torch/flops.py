"""Analytic FLOPs accounting from static shapes.

The reference prices modules by running ``pthflops.count_ops`` on probe
tensors — at model-build time to place branches
(from_deepv3_new.py:99-115), offline for the FLOPs CSVs
(eval_flops.py:15-50), and *inline per image* during sequential early-exit
inference (ee_dnn_op.py:66-105).  On TPU the probing is replaced by this
static calculator: every layer's cost is a closed-form function of its
configuration and input spatial size, so the per-exit cost table is computed
once and the hot path never pays for profiling.

Convention: 1 multiply-accumulate = 1 FLOP (the pthflops convention), so the
placement ratios — all the reference's decisions are ratio-based,
from_deepv3_new.py:83 — are directly comparable.

The unit of account is :class:`LayerCost`; modules in
``ee_semantic_segmentation_tpu.models`` expose ``flops(h, w)`` built from
these helpers.
"""

from __future__ import annotations

import dataclasses


def conv2d_flops(
    h: int,
    w: int,
    cin: int,
    cout: int,
    kernel: int | tuple[int, int],
    stride: int = 1,
    groups: int = 1,
    bias: bool = False,
) -> int:
    """MACs of a 2-D convolution producing a (h/stride, w/stride) output."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    oh, ow = -(-h // stride), -(-w // stride)
    macs = oh * ow * cout * (cin // groups) * kh * kw
    if bias:
        macs += oh * ow * cout
    return macs


def dense_flops(n: int, cin: int, cout: int, bias: bool = True) -> int:
    macs = n * cin * cout
    if bias:
        macs += n * cout
    return macs


def bn_flops(h: int, w: int, c: int) -> int:
    """Inference-mode batchnorm: scale + shift per element."""
    return 2 * h * w * c


def elementwise_flops(h: int, w: int, c: int, ops: int = 1) -> int:
    return ops * h * w * c


def pool_flops(h: int, w: int, c: int, kernel: int) -> int:
    return h * w * c * kernel * kernel


def resize_bilinear_flops(out_h: int, out_w: int, c: int) -> int:
    """4 taps + 3 lerps per output element (approximate, matches the order
    pthflops assigns to interpolate)."""
    return 7 * out_h * out_w * c


def softmax_flops(h: int, w: int, c: int) -> int:
    return 3 * h * w * c


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """FLOPs + output geometry of one layer/block at a given input size."""

    name: str
    flops: int
    out_h: int
    out_w: int
    out_c: int


def accumulate(costs) -> int:
    return int(sum(c.flops for c in costs))
