"""Per-exit cumulative FLOPs -> appended CSV.

Port of ``ee_semantic_segmentation_tpu/cli/eval_flops.py``: the same flags
(``-M``, ``-v``, ``-s``) and the ``{net_id, x, y, b{i}_flops}`` row,
appended to ``./{n}_branches_model_flops.csv``.  The numbers come from the
analytic table (``model.flops_table``): prefix-summed trunk segments plus
the exit's head.  Only the checkpoint's JSON sidecar is read, so no
weights are loaded and nothing runs on a device.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.eval_flops -M <ckpt> -s 512
"""

from __future__ import annotations

import argparse
from collections import defaultdict


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate trained models.")
    p.add_argument("-M", "--models", nargs="+", default=[])
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument("-s", "--size", type=int, nargs="+", default=[256])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import BranchyDeepLabV3
    from ee_semantic_segmentation_tpu_torch.train import checkpoint as ckpt

    img_size = args.size
    for model_path in args.models:
        res = defaultdict(list)
        if args.verbose:
            print(f"Evaluating {model_path}...")
        net_id = common.net_id_of(model_path)
        cfg = ckpt.load_config(model_path)
        if cfg is None:
            raise FileNotFoundError(f"no model spec at {model_path}.json")
        with torch.device("meta"):  # the table reads the config only
            model = BranchyDeepLabV3(cfg)
        n = cfg.n_branches
        res["net_id"].append(net_id)
        res["x"].append(img_size[0])
        if len(img_size) == 1:
            res["y"].append(img_size[0])
            table = model.flops_table(img_size[0])
        else:
            res["y"].append(img_size[1])
            table = model.flops_table((img_size[0], img_size[1]))
        for i, f in enumerate(table["cumulative_exits"]):
            res[f"b{i + 1}_flops"].append(f)
        common.append_csv(res, f"./{n}_branches_model_flops.csv")
        if args.verbose:
            print("...done")


if __name__ == "__main__":
    main()
