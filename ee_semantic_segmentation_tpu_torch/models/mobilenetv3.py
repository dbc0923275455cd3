"""Dilated MobileNetV3-Large backbone (PyTorch) with analytic FLOPs metadata.

Port of ``ee_semantic_segmentation_tpu/models/mobilenetv3.py``, torchvision's
``deeplabv3_mobilenet_v3_large`` backbone: the MobileNetV3-Large inverted
residual stack (hardswish or ReLU, squeeze-and-excite with a hard sigmoid,
squeeze width rounded to multiples of 8), the last stride-2 stage dilated
instead (output stride 16), and a final 1x1 conv to 960 channels.

The static description (``_make_divisible``, ``MNV3BlockSpec``,
``MNV3BackboneSpec``, ``mobilenet_v3_block_specs``) is a copy of the JAX
package's, with the same FLOPs and geometry protocol as
``resnet.BackboneSpec``, so the branch placement runs on it unchanged.
``MNV3Stem``, ``SqueezeExcite`` and ``InvertedResidual`` are ``nn.Module``s
on NCHW tensors whose submodules carry the flax names (``expand``,
``depthwise_bn``, ``se.fc1``, ...), so ``models/from_jax.py`` maps weights
by name: the flax depthwise kernel (k, k, 1, C) becomes the (C, 1, k, k)
weight of a ``groups=C`` conv.  BatchNorm is ``resnet.BatchNorm`` (flax's
training statistics) with torchvision's eps 1e-3.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as Fn

from ee_semantic_segmentation_tpu_torch import flops as F
from ee_semantic_segmentation_tpu_torch.models.resnet import BatchNorm


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class MNV3BlockSpec:
    name: str
    cin: int
    exp: int
    cout: int
    kernel: int
    stride: int
    dilation: int
    use_se: bool
    use_hs: bool
    is_conv1x1: bool = False  # the final 960-channel 1x1 conv "block"

    def flops(self, h: int, w: int) -> int:
        if self.is_conv1x1:
            total = F.conv2d_flops(h, w, self.cin, self.cout, 1)
            total += F.bn_flops(h, w, self.cout) + F.elementwise_flops(h, w, self.cout)
            return total
        oh, ow = -(-h // self.stride), -(-w // self.stride)
        total = 0
        if self.exp != self.cin:
            total += F.conv2d_flops(h, w, self.cin, self.exp, 1)
            total += F.bn_flops(h, w, self.exp) + F.elementwise_flops(h, w, self.exp)
        total += F.conv2d_flops(h, w, self.exp, self.exp, self.kernel, stride=self.stride,
                                groups=self.exp)
        total += F.bn_flops(oh, ow, self.exp) + F.elementwise_flops(oh, ow, self.exp)
        if self.use_se:
            squeeze = _make_divisible(self.exp // 4)
            total += F.elementwise_flops(oh, ow, self.exp)  # global pool
            total += F.dense_flops(1, self.exp, squeeze) + F.dense_flops(1, squeeze, self.exp)
            total += F.elementwise_flops(oh, ow, self.exp)  # scale
        total += F.conv2d_flops(oh, ow, self.exp, self.cout, 1)
        total += F.bn_flops(oh, ow, self.cout)
        if self.stride == 1 and self.cin == self.cout:
            total += F.elementwise_flops(oh, ow, self.cout)  # residual add
        return total

    def out_shape(self, h: int, w: int) -> tuple[int, int, int]:
        return -(-h // self.stride), -(-w // self.stride), self.cout


@dataclasses.dataclass(frozen=True)
class MNV3BackboneSpec:
    blocks: tuple[MNV3BlockSpec, ...]

    def stem_flops(self, h: int, w: int) -> int:
        oh, ow = -(-h // 2), -(-w // 2)
        return (F.conv2d_flops(h, w, 3, 16, 3, stride=2) + F.bn_flops(oh, ow, 16)
                + F.elementwise_flops(oh, ow, 16))

    def stem_out(self, h: int, w: int) -> tuple[int, int, int]:
        return -(-h // 2), -(-w // 2), 16

    def cumulative_flops(self, h: int, w: int) -> list[int]:
        cum = []
        bh, bw, _ = self.stem_out(h, w)
        total = self.stem_flops(h, w)
        for blk in self.blocks:
            total += blk.flops(bh, bw)
            bh, bw, _ = blk.out_shape(bh, bw)
            cum.append(total)
        return cum

    def block_geometry(self, h: int, w: int) -> list[tuple[int, int, int]]:
        geo = []
        bh, bw, _ = self.stem_out(h, w)
        for blk in self.blocks:
            geo.append((bh, bw, blk.cin))
            bh, bw, _ = blk.out_shape(bh, bw)
        return geo


# (kernel, exp, out, SE, HS, stride) — MobileNetV3-Large
_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]


def mobilenet_v3_block_specs(dilated: bool = True) -> MNV3BackboneSpec:
    blocks = []
    cin = 16
    dilation = 1
    for i, (k, exp, out, se, hs, stride) in enumerate(_LARGE):
        if dilated and stride == 2 and i >= 12:  # last downsampling stage
            dilation *= stride
            stride = 1
        blocks.append(MNV3BlockSpec(name=f"layer{i + 1}.0", cin=cin, exp=exp, cout=out,
                                    kernel=k, stride=stride, dilation=dilation, use_se=se,
                                    use_hs=hs))
        cin = out
    # final 1x1 conv to 6*160 = 960 (torchvision lastconv)
    blocks.append(MNV3BlockSpec(name="lastconv.0", cin=cin, exp=cin, cout=960, kernel=1,
                                stride=1, dilation=dilation, use_se=False, use_hs=True,
                                is_conv1x1=True))
    return MNV3BackboneSpec(blocks=tuple(blocks))


# torchvision's MobileNetV3 uses BatchNorm2d(eps=0.001) everywhere
BN_EPS = 1e-3


def bn(c: int) -> BatchNorm:
    # flax BatchNorm(momentum=0.9, epsilon=1e-3)
    return BatchNorm(c, eps=BN_EPS, momentum=0.1)


def conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=False)


class MNV3Stem(nn.Module):
    """conv3x3/2 (16 channels) + BN + hardswish."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 16, 3, stride=2, padding=1, bias=False)
        self.bn = bn(16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Fn.hardswish(self.bn(self.conv(x)))


class SqueezeExcite(nn.Module):
    """Global mean, 1x1 conv (bias) + ReLU, 1x1 conv (bias), hard sigmoid
    scale.  The hard sigmoid is written out as flax's ``relu6(x + 3) / 6``:
    ``F.hardsigmoid``'s backward multiplies by a float32 1/6 in every dtype,
    2.98e-8 off in float64.  It acts on (N, C, 1, 1), so the three passes
    cost nothing."""

    def __init__(self, channels: int):
        super().__init__()
        squeeze = _make_divisible(channels // 4)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(Fn.relu(self.fc1(s)))
        return x * (Fn.relu6(s + 3.0) / 6.0)


class InvertedResidual(nn.Module):
    """1x1 expand (where exp != cin), depthwise kxk (strided or dilated,
    symmetric padding ``(k - 1) // 2 * dilation``), optional SE, 1x1
    project; the residual only where stride is 1 and cin == cout.  The
    final ``is_conv1x1`` block is a 1x1 conv + BN + hardswish."""

    def __init__(self, spec: MNV3BlockSpec):
        super().__init__()
        s = spec
        self.spec = s
        if s.is_conv1x1:
            self.conv = conv1x1(s.cin, s.cout)
            self.bn = bn(s.cout)
            return
        if s.exp != s.cin:
            self.expand = conv1x1(s.cin, s.exp)
            self.expand_bn = bn(s.exp)
        self.depthwise = nn.Conv2d(s.exp, s.exp, s.kernel, stride=s.stride,
                                   padding=(s.kernel - 1) // 2 * s.dilation,
                                   dilation=s.dilation, groups=s.exp, bias=False)
        self.depthwise_bn = bn(s.exp)
        if s.use_se:
            self.se = SqueezeExcite(s.exp)
        self.project = conv1x1(s.exp, s.cout)
        self.project_bn = bn(s.cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        act = Fn.hardswish if s.use_hs else Fn.relu
        if s.is_conv1x1:
            return act(self.bn(self.conv(x)))
        y = x
        if s.exp != s.cin:
            y = act(self.expand_bn(self.expand(y)))
        y = act(self.depthwise_bn(self.depthwise(y)))
        if s.use_se:
            y = self.se(y)
        y = self.project_bn(self.project(y))
        if s.stride == 1 and s.cin == s.cout:
            y = y + x
        return y
