"""ASPP, DeepLabHead and the custom branch head (PyTorch, NCHW).

Port of ``ee_semantic_segmentation_tpu/models/aspp.py``, which mirrors the
torchvision modules the reference composes:

* ``ASPP(cin, rates, cout)``: 1x1 branch, one 3x3 atrous branch per rate,
  global-average-pooling branch, concat, 1x1 projection (+ dropout 0.5,
  active only in training),
* ``DeepLabHead(cin, classes)`` = ASPP(cin, (12, 24, 36), 256) + 3x3 conv +
  BN + ReLU + 1x1 classifier,
* ``BranchHead`` = the reference's ``my_branch``: optional 1x1 bottleneck,
  ASPP, 3x3 conv + BN + ReLU, 1x1 classifier.

The ``*_flops`` companions are copies of the JAX package's.  Unlike flax,
torch needs each module's input width at construction, so every head takes
``cin``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as Fn

from ee_semantic_segmentation_tpu_torch import flops as F
from ee_semantic_segmentation_tpu_torch.models.resnet import bn, conv


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (torchvision layout)."""

    def __init__(self, cin: int, out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), dropout_rate: float = 0.5):
        super().__init__()
        cout = out_channels
        self.n_rates = len(atrous_rates)
        self.conv0 = conv(cin, cout, 1)
        self.bn0 = bn(cout)
        for i, rate in enumerate(atrous_rates, start=1):
            setattr(self, f"conv{i}", conv(cin, cout, 3, dilation=rate))
            setattr(self, f"bn{i}", bn(cout))
        self.pool_conv = conv(cin, cout, 1)
        self.pool_bn = bn(cout)
        self.project = conv((self.n_rates + 2) * cout, cout, 1)
        self.project_bn = bn(cout)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [Fn.relu(self.bn0(self.conv0(x)))]
        for i in range(1, self.n_rates + 1):
            conv_i, bn_i = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            branches.append(Fn.relu(bn_i(conv_i(x))))
        g = x.mean(dim=(2, 3), keepdim=True)
        g = Fn.relu(self.pool_bn(self.pool_conv(g)))
        branches.append(g.expand_as(branches[0]))  # broadcast, as in JAX
        y = torch.cat(branches, dim=1)
        y = Fn.relu(self.project_bn(self.project(y)))
        return self.dropout(y)


def aspp_flops(h: int, w: int, cin: int, cout: int = 256, n_rates: int = 3) -> int:
    total = F.conv2d_flops(h, w, cin, cout, 1) + F.bn_flops(h, w, cout) + F.elementwise_flops(h, w, cout)
    for _ in range(n_rates):
        total += F.conv2d_flops(h, w, cin, cout, 3) + F.bn_flops(h, w, cout) + F.elementwise_flops(h, w, cout)
    # pooling branch: global mean + 1x1 on 1x1 + broadcast
    total += F.elementwise_flops(h, w, cin)
    total += F.conv2d_flops(1, 1, cin, cout, 1) + F.bn_flops(1, 1, cout)
    # projection over concatenated (n_rates + 2) * cout channels
    total += F.conv2d_flops(h, w, (n_rates + 2) * cout, cout, 1)
    total += F.bn_flops(h, w, cout) + F.elementwise_flops(h, w, cout)
    return total


class DeepLabHead(nn.Module):
    """torchvision DeepLabHead: ASPP + 3x3 conv + BN + ReLU + 1x1 classifier."""

    def __init__(self, cin: int, num_classes: int = 21, mid_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), dropout_rate: float = 0.5):
        super().__init__()
        self.aspp = ASPP(cin, mid_channels, atrous_rates, dropout_rate)
        self.conv = conv(mid_channels, mid_channels, 3)
        self.bn = bn(mid_channels)
        self.classifier = conv(mid_channels, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = Fn.relu(self.bn(self.conv(self.aspp(x))))
        return self.classifier(x)


def deeplab_head_flops(h: int, w: int, cin: int, num_classes: int = 21, mid: int = 256) -> int:
    total = aspp_flops(h, w, cin, mid)
    total += F.conv2d_flops(h, w, mid, mid, 3) + F.bn_flops(h, w, mid) + F.elementwise_flops(h, w, mid)
    total += F.conv2d_flops(h, w, mid, num_classes, 1, bias=True)
    return total


class BranchHead(nn.Module):
    """The reference's ``my_branch``: optional 1x1 bottleneck, ASPP with
    custom rates/width, 3x3 conv + BN + ReLU, 1x1."""

    def __init__(self, cin: int, num_classes: int = 21, nout_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), bottleneck: int | None = None,
                 dropout_rate: float = 0.5):
        super().__init__()
        if bottleneck:
            self.bottleneck = conv(cin, bottleneck, 1, bias=True)
            cin = bottleneck
        else:
            self.bottleneck = None
        self.aspp = ASPP(cin, nout_channels, atrous_rates, dropout_rate)
        self.conv = conv(nout_channels, nout_channels, 3)
        self.bn = bn(nout_channels)
        self.classifier = conv(nout_channels, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bottleneck is not None:
            x = self.bottleneck(x)
        x = Fn.relu(self.bn(self.conv(self.aspp(x))))
        return self.classifier(x)


def branch_head_flops(
    h: int,
    w: int,
    cin: int,
    num_classes: int = 21,
    nout: int = 256,
    n_rates: int = 3,
    bottleneck: int | None = None,
) -> int:
    total = 0
    if bottleneck:
        total += F.conv2d_flops(h, w, cin, bottleneck, 1, bias=True)
        cin = bottleneck
    total += aspp_flops(h, w, cin, nout, n_rates)
    total += F.conv2d_flops(h, w, nout, nout, 3) + F.bn_flops(h, w, nout) + F.elementwise_flops(h, w, nout)
    total += F.conv2d_flops(h, w, nout, num_classes, 1, bias=True)
    return total
