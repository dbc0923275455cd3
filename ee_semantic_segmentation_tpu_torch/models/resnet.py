"""Dilated ResNet-50/101 backbone (PyTorch) with analytic FLOPs metadata.

Port of ``ee_semantic_segmentation_tpu/models/resnet.py``.  The static block
description (``BlockSpec``, ``BackboneSpec``, ``resnet_block_specs``) is a
copy; ``ResNetStem`` and ``Bottleneck`` are ``nn.Module``s with torchvision
semantics: output stride 8 via dilation in layer3/layer4, BN eps 1e-5,
symmetric conv padding, no padding on the 1x1 downsample, and -inf padding
in the max-pool.  Modules take and return NCHW tensors.

Submodule names follow the flax parameter tree (``conv1``, ``bn1``, ...,
``downsample_conv``, ``downsample_bn``) so ``models/from_jax.py`` maps
weights by name.  The JAX package's space-to-depth stem is not ported
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as Fn

from ee_semantic_segmentation_tpu_torch import flops as F


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static description of one bottleneck block."""

    name: str  # torchvision-style "layer1.0"
    cin: int
    width: int
    cout: int
    stride: int
    dilation: int
    downsample: bool

    def flops(self, h: int, w: int) -> int:
        oh, ow = -(-h // self.stride), -(-w // self.stride)
        total = F.conv2d_flops(h, w, self.cin, self.width, 1)
        total += F.bn_flops(h, w, self.width) + F.elementwise_flops(h, w, self.width)
        total += F.conv2d_flops(h, w, self.width, self.width, 3, stride=self.stride)
        total += F.bn_flops(oh, ow, self.width) + F.elementwise_flops(oh, ow, self.width)
        total += F.conv2d_flops(oh, ow, self.width, self.cout, 1)
        total += F.bn_flops(oh, ow, self.cout)
        if self.downsample:
            total += F.conv2d_flops(h, w, self.cin, self.cout, 1, stride=self.stride)
            total += F.bn_flops(oh, ow, self.cout)
        total += 2 * F.elementwise_flops(oh, ow, self.cout)  # add + relu
        return total

    def out_shape(self, h: int, w: int) -> tuple[int, int, int]:
        return -(-h // self.stride), -(-w // self.stride), self.cout


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Stem + ordered block list + geometry helpers."""

    depth: int
    blocks: tuple[BlockSpec, ...]

    def stem_flops(self, h: int, w: int) -> int:
        oh, ow = -(-h // 2), -(-w // 2)
        total = F.conv2d_flops(h, w, 3, 64, 7, stride=2)
        total += F.bn_flops(oh, ow, 64) + F.elementwise_flops(oh, ow, 64)
        ph, pw = -(-oh // 2), -(-ow // 2)
        total += F.pool_flops(ph, pw, 64, 3)
        return total

    def stem_out(self, h: int, w: int) -> tuple[int, int, int]:
        return -(-h // 4), -(-w // 4), 64

    def cumulative_flops(self, h: int, w: int) -> list[int]:
        """Cumulative FLOPs (stem + blocks[0..i]) and per-block geometry."""
        cum = []
        bh, bw, _ = self.stem_out(h, w)
        total = self.stem_flops(h, w)
        for blk in self.blocks:
            total += blk.flops(bh, bw)
            bh, bw, _ = blk.out_shape(bh, bw)
            cum.append(total)
        return cum

    def block_geometry(self, h: int, w: int) -> list[tuple[int, int, int]]:
        """Input geometry (h, w, cin) of each block at input image size."""
        geo = []
        bh, bw, bc = self.stem_out(h, w)
        for blk in self.blocks:
            geo.append((bh, bw, blk.cin))
            bh, bw, bc = blk.out_shape(bh, bw)
        return geo


_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def resnet_block_specs(
    depth: int = 101,
    output_stride: int = 8,
) -> BackboneSpec:
    """Build the torchvision-compatible dilated block list."""
    counts = _STAGE_BLOCKS[depth]
    widths = (64, 128, 256, 512)
    if output_stride == 8:
        dilate = (False, False, True, True)
    elif output_stride == 16:
        dilate = (False, False, False, True)
    else:
        dilate = (False, False, False, False)

    blocks: list[BlockSpec] = []
    cin = 64
    dilation = 1
    for stage, (n_blocks, width) in enumerate(zip(counts, widths)):
        stride = 1 if stage == 0 else 2
        previous_dilation = dilation
        if dilate[stage]:
            dilation *= stride
            stride = 1
        cout = width * 4
        for i in range(n_blocks):
            blocks.append(
                BlockSpec(
                    name=f"layer{stage + 1}.{i}",
                    cin=cin if i == 0 else cout,
                    width=width,
                    cout=cout,
                    stride=stride if i == 0 else 1,
                    dilation=previous_dilation if i == 0 else dilation,
                    downsample=(i == 0 and (stride != 1 or cin != cout)),
                )
            )
        cin = cout
    return BackboneSpec(depth=depth, blocks=tuple(blocks))


def conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """``nn.Conv`` counterpart: symmetric padding ``dilation * (k // 2)``
    (the flax modules pass ``padding=dilation`` for 3x3 and pad a 1x1 by
    nothing)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    # flax BatchNorm(momentum=0.9) == torch momentum 0.1; eps 1e-5 in both
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ResNetStem(nn.Module):
    """conv7x7/2 + BN + ReLU + maxpool3x3/2 (torchvision stem)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = Fn.relu(self.bn1(self.conv1(x)))
        return Fn.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce, 3x3 (stride/dilated), 1x1 expand."""

    def __init__(self, spec: BlockSpec):
        super().__init__()
        s = spec
        self.spec = s
        self.conv1 = conv(s.cin, s.width, 1)
        self.bn1 = bn(s.width)
        self.conv2 = conv(s.width, s.width, 3, stride=s.stride, dilation=s.dilation)
        self.bn2 = bn(s.width)
        self.conv3 = conv(s.width, s.cout, 1)
        self.bn3 = bn(s.cout)
        if s.downsample:
            self.downsample_conv = conv(s.cin, s.cout, 1, stride=s.stride)
            self.downsample_bn = bn(s.cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = Fn.relu(self.bn1(self.conv1(x)))
        out = Fn.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.spec.downsample else x
        return Fn.relu(out + identity)
