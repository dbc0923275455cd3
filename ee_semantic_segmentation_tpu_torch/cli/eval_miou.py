"""Per-exit test mIoU of saved models -> appended CSV.

Port of ``ee_semantic_segmentation_tpu/cli/eval_miou.py``: same flags, same
``{net_id, b{i}_mIoU..., mIoU}`` CSV row schema, plus ``--device``.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.eval_miou -M <ckpt> \\
        -c 21 -D 512 512 -d synthetic -b 12 --pallas_head
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict


def build_parser():
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Evaluate trained models.")
    p.add_argument("-M", "--models", nargs="+", default=[])
    p.add_argument("-c", "--n_classes", type=int, default=None)
    p.add_argument("-D", "--dimensions", type=int, nargs="+", default=[256, 256])
    p.add_argument("-d", "--dataset", type=str, default=None)
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument("-n", "--n_branches", type=int, default=0)
    p.add_argument("-s", "--save_at", type=str, default="mIoU_results")
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--pallas_head", action="store_true", default=False,
                   help="use the fused CUDA upsample+argmax+confusion eval head "
                        "(ops/kernels/upsample_argmax.py): no full-res float32 "
                        "logits in device memory")
    common.add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.n_classes or args.n_classes < 0:
        raise Exception("Number of classes unspecified! Unnable to compute mIoU.")

    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )

    device = common.resolve_device(args.device)
    input_dim = common.resolve_dims(args.dimensions)
    test_set = common.resolve_test_set(args.dataset, input_dim)
    loader = DataLoader(test_set, args.batch_size)

    res = defaultdict(list)
    for model_path in args.models:
        net_id = common.net_id_of(model_path)
        model = common.load_model(model_path, device)
        if args.verbose:
            print(f"Evaluating {net_id}...")
        res["net_id"].append(net_id)
        n_exits = (args.n_branches or model.config.n_branches) + 1
        step = make_kernel_miou_step_fn(model, args.n_classes) if args.pallas_head else None
        vals = mIoU_evaluator_fused(model, n_exits, args.n_classes, loader, step=step)
        for k, v in vals.items():
            res[k].append(v)
        if args.verbose:
            print(f"... finished evaluation of {net_id}")

    save_at = args.save_at if args.save_at.endswith("csv") else f"{args.save_at}.csv"
    common.append_csv(res, os.path.join(os.getcwd(), save_at))


if __name__ == "__main__":
    main()
