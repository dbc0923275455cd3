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


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training statistics.

    In training, flax normalises with the batch mean and the *biased* batch
    variance and moves ``batch_stats`` toward those same two values
    (``var <- 0.9 var + 0.1 E[(x - E x)^2]``); ``nn.BatchNorm2d`` moves
    ``running_var`` toward the *unbiased* variance, n/(n - 1) times larger
    (a factor of 2 for the ASPP pooling branch at batch 2), and refuses one
    value per channel, which flax takes (the pooled (1, C, 1, 1) tensor at
    batch 1).  Here, in training:

    * the output is ``torch.native_batch_norm`` in training mode without
      running buffers: one pass for the biased batch statistics (accumulated
      in at least float32), one to normalise, and the fused backward.  With
      one value per channel the variance is 0, so the output is the shift
      ``bias`` and the input gradient 0, as in flax;
    * under ``no_grad`` the running buffers take flax's update with
      ``momentum`` 0.1 (flax's 0.9) from the mean and inverse standard
      deviation that call returns, the biased variance being
      ``invstd^-2 - eps``: the input is not read a third time.

    Eval mode is ``nn.BatchNorm2d``'s own: ``F.batch_norm`` with the running
    statistics.  Parameter and buffer names are ``nn.BatchNorm2d``'s, so
    state dicts and ``models/from_jax.py`` are unchanged.

    With a data-parallel ``mesh`` (:func:`sync_batchnorm`), training takes
    the statistics of the global batch, as the JAX package's BatchNorm does
    on a sharded batch: :class:`_GlobalBatchNorm`.
    """

    mesh = None  # a parallel.mesh.DataMesh: global-batch statistics in training

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.mesh is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.mesh,
                                                  x.is_cuda)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
                self.num_batches_tracked.add_(1)
            return y
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            invstd = invstd.to(torch.promote_types(invstd.dtype, torch.float32))
            var = (invstd.pow(-2) - self.eps).clamp_min_(0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of a data-parallel mesh
    (``torch.nn.SyncBatchNorm``'s pattern, with flax's statistics).

    Forward: each rank's (count, mean, biased variance) per channel, all
    gathered and combined (Chan's parallel variance; an empty shard has
    count 0 and adds nothing), normalise with the global mean and biased
    variance.  Returns (y, mean, var) so the module moves its running
    buffers toward the biased variance, as flax does (``SyncBatchNorm``
    moves them toward the unbiased one).  Backward: each rank's two sums
    (of dy and of dy * (x - mean)) are all-reduced, so the input gradient
    is that of the global normalisation; the scale and shift gradients
    are this rank's shares, which the train step sums.

    With ``fused`` (CUDA tensors only) the statistics and the two
    elementwise passes are PyTorch's fused SyncBatchNorm operators
    (``batch_norm_stats``, ``batch_norm_elemt``,
    ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``), which
    exist for CUDA only; else the same arithmetic in plain operations, the
    version ``chip_smoke.py`` holds the fused one to."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh, fused):
        from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

        C = x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        n = x.numel() // C
        if n == 0:
            mean = var = x.new_zeros(C, dtype=acc)
        elif fused:
            mean, invstd = torch.batch_norm_stats(x, eps)
            mean, var = mean.to(acc), (invstd.to(acc).pow(-2) - eps).clamp_min(0.0)
        else:
            var, mean = torch.var_mean(x.to(acc), dim=(0, 2, 3), correction=0)
        stats = pm.all_gather(torch.cat([mean.new_full((1,), n), mean, var]), mesh)
        counts, means, variances = stats[:, :1], stats[:, 1:C + 1], stats[:, C + 1:]
        total = counts.sum().clamp_min(1.0)
        g_mean = (counts * means).sum(0) / total
        g_var = (counts * (variances + (means - g_mean).square())).sum(0) / total
        invstd = torch.rsqrt(g_var + eps)
        if n == 0:
            y = torch.empty_like(x)
        elif fused:
            y = torch.batch_norm_elemt(x, weight, bias, g_mean, invstd, eps)
        else:
            y = ((x.to(acc) - _per_channel(g_mean)) * _per_channel(invstd * weight)
                 + _per_channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, weight, g_mean, invstd, counts.view(-1))
        ctx.mesh, ctx.fused = mesh, fused
        ctx.mark_non_differentiable(g_mean, g_var)
        return y, g_mean, g_var

    @staticmethod
    def backward(ctx, gy, _g_mean, _g_var):
        from ee_semantic_segmentation_tpu_torch.parallel import mesh as pm

        x, weight, mean, invstd, counts = ctx.saved_tensors
        C = x.shape[1]
        empty = x.numel() == 0
        if empty:
            sum_dy = sum_dy_xmu = mean.new_zeros(C)
            g_weight, g_bias = torch.zeros_like(weight), torch.zeros_like(weight)
        elif ctx.fused:
            fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            gy = gy.contiguous(memory_format=fmt)
            sum_dy, sum_dy_xmu, g_weight, g_bias = torch.batch_norm_backward_reduce(
                gy, x, mean, invstd, weight, True, True, True)
        else:
            g = gy.to(mean.dtype)
            xmu = x.to(mean.dtype) - _per_channel(mean)
            sum_dy, sum_dy_xmu = g.sum((0, 2, 3)), (g * xmu).sum((0, 2, 3))
            g_weight, g_bias = (sum_dy_xmu * invstd).to(weight.dtype), sum_dy.to(weight.dtype)
        sums = pm.all_reduce(torch.cat([sum_dy, sum_dy_xmu]), ctx.mesh)
        sum_dy, sum_dy_xmu = sums[:C], sums[C:]
        if empty:
            gx = torch.zeros_like(x)
        elif ctx.fused:
            gx = torch.batch_norm_backward_elemt(gy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                                                 counts.to(torch.int32))
        else:
            total = counts.sum()
            gx = (_per_channel(weight.to(mean.dtype) * invstd)
                  * (g - _per_channel(sum_dy / total)
                     - xmu * _per_channel(invstd.square() * sum_dy_xmu / total))).to(x.dtype)
        return gx, g_weight, g_bias, None, None, None


def sync_batchnorm(model: nn.Module, mesh) -> nn.Module:
    """Give every :class:`BatchNorm` of ``model`` the data-parallel ``mesh``
    (None: back to per-process statistics); returns the model."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    return model


def bn(c: int) -> BatchNorm:
    # flax BatchNorm(momentum=0.9) == momentum 0.1 here; eps 1e-5 in both
    return BatchNorm(c, eps=1e-5, momentum=0.1)


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
