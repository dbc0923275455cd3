"""Similarity-gated policy evaluation -> appended CSV.

Port of ``ee_semantic_segmentation_tpu/cli/eval_br_sim.py`` (and, through
``image_level``, of its ``eval_br_images``): the same flags (-m
ssim|mse|nmi|vi|h_xy|h_yx, -t threshold, -S skip) and the same CSV row
schema (b{i}_mIoU, b{i}_count, mIoU_out, count_out, mIoU_gl, out_gl, t,
metric), plus ``--device``; under ``torchrun`` data-parallel.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.eval_br_sim -M <ckpt> \\
        -c 21 -D 512 512 -d synthetic -b 12 -m ssim -t 0.5 --pallas_head
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

METRICS = ("ssim", "mse", "nmi", "vi", "h_xy", "h_yx")


def build_parser():
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Evaluate trained models.")
    p.add_argument("-M", "--models", nargs="+", default=[])
    p.add_argument("-c", "--n_classes", type=int, default=None)
    p.add_argument("-D", "--dimensions", type=int, nargs="+", default=[256, 256])
    p.add_argument("-d", "--dataset", type=str, default=None)
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument("-n", "--n_branches", type=int, default=0)
    p.add_argument("-s", "--save_at", type=str, default="sim_results")
    p.add_argument("-m", "--metric", type=str, default=None)
    p.add_argument("-t", "--threshold", type=float, default=0.5)
    p.add_argument("-S", "--skip", type=int, default=0)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--pallas_head", action="store_true", default=False,
                   help="fused CUDA upsample+argmax head for the exit label maps "
                        "(identical counts; no full-res float32 logits in device memory)")
    common.add_device_flag(p)
    return p


def main(argv=None, image_level: bool = False):
    args = build_parser().parse_args(argv)
    if (args.metric or "").lower() not in METRICS:
        raise ValueError(f"-m must be one of {', '.join(METRICS)}; got {args.metric!r}")
    if not args.n_classes or args.n_classes < 0:
        raise Exception("Number of classes unspecified! Unnable to compute mIoU.")

    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        br_evaluator_similarity,
        br_evaluator_similarity_fused,
    )

    device, mesh = common.resolve_device_and_mesh(args.device)
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
        kw = dict(ignore=(args.n_classes - 1,), skip=args.skip, mesh=mesh)
        if image_level:
            vals = br_evaluator_similarity(model, n_exits, args.n_classes, loader, args.metric,
                                           args.threshold, image_level=True, **kw)
        else:
            vals = br_evaluator_similarity_fused(model, n_exits, args.n_classes, loader,
                                                 args.metric, args.threshold,
                                                 pallas_head=args.pallas_head, **kw)
        for k, v in vals.items():
            res[k].append(v)
        if args.verbose:
            print(f"... finished evaluation of {net_id}")

    save_at = args.save_at if args.save_at.endswith("csv") else f"{args.save_at}.csv"
    common.append_csv(res, os.path.join(os.getcwd(), save_at), fillna=0)


if __name__ == "__main__":
    main()
