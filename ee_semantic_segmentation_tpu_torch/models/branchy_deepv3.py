"""Branchy DeepLabV3: multi-exit segmenter with analytic branch placement.

Port of ``ee_semantic_segmentation_tpu/models/branchy_deepv3.py``.
``BranchyConfig``, ``place_branches``, ``flops_table`` and
``build_branchy_deeplabv3`` are copies of the JAX package's (the placement
rule equipartitions the trunk's analytic FLOPs); ``BranchyDeepLabV3`` is an
``nn.Module``.

Layout: the public methods keep the JAX package's boundary layout — images
are NHWC ``(N, H, W, 3)``, ``forward`` returns ``(E, N, H, W, C)`` and
``lowres_logits`` a list of ``(N, h, w, C)``.  Inside, the trunk and heads
run NCHW; a model moved to ``channels_last`` (``cli/common.load_model``
does) makes both permutes free, because an NHWC tensor viewed as NCHW *is*
channels-last.

Submodules are named after the flax tree (``stem.conv1``,
``blocks.{i}.conv2``, ``branches.{k}.aspp.conv0``,
``classifier.classifier``) so ``models/from_jax.py`` converts weights by
name.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
import torch.nn.functional as Fn

from ee_semantic_segmentation_tpu_torch.models import aspp as heads
from ee_semantic_segmentation_tpu_torch.models import mobilenetv3 as M
from ee_semantic_segmentation_tpu_torch.models import resnet as R


@dataclasses.dataclass(frozen=True)
class BranchyConfig:
    """Static architecture description (the JSON-serializable "model spec"
    that replaces the reference's whole-module pickles,
    deepv3_funcs.py:186-188)."""

    backbone_depth: int
    img_dim: int | tuple[int, int]  # square side, or (H, W) for non-square
    n_branches: int
    segment_ends: tuple[int, ...]  # block index (exclusive) closing each segment
    branch_channels: tuple[int, ...]  # cin of each branch head
    num_classes: int = 21
    count_branches: bool = True
    skip: int = 0
    branch_params: dict | None = None  # {'atrous_rates': ..., 'nout_channels': ..., 'bottleneck': ...}
    backbone: str = "resnet"  # 'resnet' | 'mobilenet_v3_large'
    classifier_mid: int = 256  # DeepLabHead width (torchvision default 256)
    head_dropout: float = 0.5  # ASPP projection dropout (torchvision default)

    @property
    def n_exits(self) -> int:
        return self.n_branches + 1

    @property
    def img_hw(self) -> tuple[int, int]:
        d = self.img_dim
        return (d, d) if isinstance(d, int) else (int(d[0]), int(d[1]))


def backbone_spec(cfg: "BranchyConfig"):
    """Resolve the static backbone description for a config."""
    if cfg.backbone == "mobilenet_v3_large":
        return M.mobilenet_v3_block_specs()
    return R.resnet_block_specs(cfg.backbone_depth)


def _uses_custom_branch(bp) -> bool:
    return isinstance(bp, dict) and all(k in bp for k in ("nout_channels", "atrous_rates"))


def _branch_flops_fn(cfg_branch_params, num_classes):
    bp = cfg_branch_params
    if _uses_custom_branch(bp):
        return lambda h, w, cin: heads.branch_head_flops(
            h,
            w,
            cin,
            num_classes=num_classes,
            nout=bp["nout_channels"],
            n_rates=len(bp["atrous_rates"]),
            bottleneck=bp.get("bottleneck"),
        )
    return lambda h, w, cin: heads.deeplab_head_flops(h, w, cin, num_classes=num_classes)


def place_branches(
    spec: R.BackboneSpec,
    n: int,
    img_dim: int | tuple[int, int],
    count_branches: bool = True,
    skip: int = 0,
    branch_params: dict | None = None,
    num_classes: int = 21,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """FLOPs-equipartition branch placement (from_deepv3_new.py:68-95).

    Returns (segment_ends, branch_channels): ``segment_ends[k]`` is the
    exclusive block index closing segment ``k`` (one entry per placed branch;
    the final segment runs to the end), ``branch_channels[k]`` is the channel
    count feeding branch ``k``.
    """
    ih, iw = (img_dim, img_dim) if isinstance(img_dim, int) else img_dim
    cum = spec.cumulative_flops(ih, iw)
    geo = spec.block_geometry(ih, iw)
    tot_flops = cum[-1]
    flop_pos = tot_flops / (n + 1)
    bflops = _branch_flops_fn(branch_params, num_classes)

    segment_ends: list[int] = []
    branch_channels: list[int] = []
    branch_extra = 0  # accumulated branch-head FLOPs (count_branches mode)
    for i, blk in enumerate(spec.blocks):
        k = len(segment_ends)
        running = cum[i] + (branch_extra if count_branches else 0)
        if n > k and tot_flops > running > flop_pos * (k + 1 + skip):
            segment_ends.append(i + 1)
            # branch head sees the *output* of block i
            if i + 1 < len(geo):
                bh, bw, _ = geo[i + 1]
            else:
                bh, bw, _ = spec.blocks[i].out_shape(*geo[i][:2])
            cout = spec.blocks[i].cout
            branch_channels.append(cout)
            if count_branches:
                branch_extra += bflops(bh, bw, cout)
    return tuple(segment_ends), tuple(branch_channels)


def _init_like_flax(module: nn.Module) -> None:
    """Random init as the JAX package draws it: conv kernels lecun-normal
    (truncated at 2 std), biases 0, BN scale 1 / shift 0.  Keeps a seeded
    port model's activation scale comparable to a freshly built JAX one."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class BranchyDeepLabV3(nn.Module):
    """Multi-exit DeepLabV3 with a dilated ResNet or MobileNetV3-Large trunk."""

    def __init__(self, config: BranchyConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        spec = backbone_spec(cfg)
        self.spec = spec
        if cfg.backbone == "mobilenet_v3_large":
            stem_cls, block_cls = M.MNV3Stem, M.InvertedResidual
        else:
            stem_cls, block_cls = R.ResNetStem, R.Bottleneck
        self.stem = stem_cls()
        self.blocks = nn.ModuleList(block_cls(blk) for blk in spec.blocks)
        bp = cfg.branch_params
        branch_list = []
        for k in range(cfg.n_branches):
            cin = cfg.branch_channels[k]
            if _uses_custom_branch(bp):
                branch_list.append(heads.BranchHead(
                    cin,
                    num_classes=cfg.num_classes,
                    nout_channels=bp["nout_channels"],
                    atrous_rates=tuple(bp["atrous_rates"]),
                    bottleneck=bp.get("bottleneck"),
                    dropout_rate=cfg.head_dropout,
                ))
            else:
                branch_list.append(heads.DeepLabHead(
                    cin, num_classes=cfg.num_classes, dropout_rate=cfg.head_dropout))
        self.branches = nn.ModuleList(branch_list)
        self.classifier = heads.DeepLabHead(
            spec.blocks[-1].cout,
            num_classes=cfg.num_classes,
            mid_channels=cfg.classifier_mid,
            dropout_rate=cfg.head_dropout,
        )
        _init_like_flax(self)

    @staticmethod
    def _upsample(y: torch.Tensor, out_hw) -> torch.Tensor:
        """(N, C, h, w) -> (N, H, W, C) bilinear (half-pixel centres, the
        ``jax.image.resize`` upsampling semantics), at least in float32."""
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        y = Fn.interpolate(y, size=tuple(out_hw), mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def _nhwc(y: torch.Tensor) -> torch.Tensor:
        return y.permute(0, 2, 3, 1).contiguous()

    def run_segment(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        """Run segment ``idx`` of the trunk on NCHW features (the stem folds
        into segment 0, whose input is the NCHW image)."""
        start = 0 if idx == 0 else self.config.segment_ends[idx - 1]
        end = (list(self.config.segment_ends) + [len(self.blocks)])[idx]
        if idx == 0:
            x = self.stem(x)
        for b in self.blocks[start:end]:
            x = b(x)
        return x

    def run_branch(self, idx: int, x: torch.Tensor, out_hw) -> torch.Tensor:
        """Branch ``idx`` on NCHW features -> (N, H, W, C) upsampled logits."""
        return self._upsample(self.branches[idx](x), out_hw)

    def run_classifier(self, x: torch.Tensor, out_hw) -> torch.Tensor:
        return self._upsample(self.classifier(x), out_hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) images -> (n_exits, N, H, W, C) float32 logits."""
        cfg = self.config
        out_hw = x.shape[1:3]
        x = x.permute(0, 3, 1, 2)
        outputs = []
        for i in range(cfg.n_branches):
            x = self.run_segment(i, x)
            outputs.append(self.run_branch(i, x, out_hw))
        x = self.run_segment(cfg.n_branches, x)
        outputs.append(self.run_classifier(x, out_hw))
        return torch.stack(outputs)

    def lowres_logits(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(N, H, W, 3) images -> per-exit LOW-RES logits, a list of
        contiguous (N, h_k, w_k, C) — the forward without the bilinear
        upsamples.  Feeds the fused CUDA upsample heads
        (ops/kernels/upsample_argmax.py)."""
        cfg = self.config
        x = x.permute(0, 3, 1, 2)
        outputs = []
        for i in range(cfg.n_branches):
            x = self.run_segment(i, x)
            outputs.append(self._nhwc(self.branches[i](x)))
        x = self.run_segment(cfg.n_branches, x)
        outputs.append(self._nhwc(self.classifier(x)))
        return outputs

    # ---------------------------------------------------------------- FLOPs
    def flops_table(self, img_dim: int | tuple[int, int] | None = None):
        """Per-segment / per-branch FLOPs (analytic) — the equivalent of
        eval_flops.count_flops (eval_flops.py:28-50).

        Returns dict with 'segments' (list, incl. final), 'branches' (list,
        incl. classifier), 'cumulative_exits' (prefix-summed trunk + head per
        exit, the b{i}_flops CSV column)."""
        cfg = self.config
        if img_dim is None:
            img_dim = cfg.img_dim
        h, w = (img_dim, img_dim) if isinstance(img_dim, int) else img_dim
        spec = backbone_spec(cfg)
        cum = spec.cumulative_flops(h, w)
        geo = spec.block_geometry(h, w)
        ends = list(cfg.segment_ends) + [len(spec.blocks)]
        bflops = _branch_flops_fn(cfg.branch_params, cfg.num_classes)

        seg_flops = []
        prev_cum = 0
        for e in ends:
            seg_flops.append(cum[e - 1] - prev_cum)
            prev_cum = cum[e - 1]

        br_flops = []
        for e in ends[:-1]:
            bh, bw, _ = spec.blocks[e - 1].out_shape(*geo[e - 1][:2])
            br_flops.append(bflops(bh, bw, spec.blocks[e - 1].cout))
        # classifier head on final trunk output
        fh, fw, _ = spec.blocks[-1].out_shape(*geo[-1][:2])
        br_flops.append(
            heads.deeplab_head_flops(
                fh, fw, spec.blocks[-1].cout, num_classes=cfg.num_classes,
                mid=cfg.classifier_mid,
            )
        )

        cumulative = []
        running = 0
        for s, b in zip(seg_flops, br_flops):
            running += s
            cumulative.append(running + b)
        return {"segments": seg_flops, "branches": br_flops, "cumulative_exits": cumulative}


def build_branchy_deeplabv3(
    depth: int = 101,
    n: int = 0,
    img_dim: int | tuple[int, int] = 256,
    count_branches: bool = True,
    skip: int = 0,
    branch_params: dict | None = None,
    num_classes: int = 21,
    backbone: str = "resnet",
    classifier_mid: int = 256,
) -> BranchyDeepLabV3:
    """Build the model the way the reference's constructor does
    (from_deepv3_new.py:57-97): place branches by FLOPs equipartition, then
    instantiate.  The realized ``n_branches`` may be smaller than requested.
    Weights come from the global torch RNG (seed it for a reproducible
    model); the model is on the CPU in float32."""
    if isinstance(img_dim, (tuple, list)):
        img_dim = tuple(int(d) for d in img_dim)
        if img_dim[0] == img_dim[1]:
            img_dim = img_dim[0]
    probe = BranchyConfig(
        backbone_depth=depth, img_dim=img_dim, n_branches=0, segment_ends=(),
        branch_channels=(), backbone=backbone,
    )
    spec = backbone_spec(probe)
    ends, chans = place_branches(
        spec, n, img_dim, count_branches=count_branches, skip=skip,
        branch_params=branch_params, num_classes=num_classes,
    )
    cfg = BranchyConfig(
        backbone_depth=depth,
        img_dim=img_dim,
        n_branches=len(ends),
        segment_ends=ends,
        branch_channels=chans,
        num_classes=num_classes,
        count_branches=count_branches,
        skip=skip,
        branch_params=branch_params,
        backbone=backbone,
        classifier_mid=classifier_mid,
    )
    return BranchyDeepLabV3(cfg)
