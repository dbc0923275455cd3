"""Train branchy DeepLabV3 with multi-exit Lovász-Softmax.

Port of ``ee_semantic_segmentation_tpu/cli/main_bradeepv3.py`` (the
reference's ``main_bradeepv3.py``): the same flags, plus ``--device``, and
the same experiment dict — loss ``LovaszSoftmax(classes='present',
ignore=void, n_branches)`` driving ``train/trainer.eval_deepv3``.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.main_bradeepv3 \\
        -t resnet50 -n 2 -D 512 -b 16 -e 1 -d synthetic -l 0.01

Checkpoints land in ``./<dataset>_results/<Name>/<Name>{.pt,.opt.pt,.json}``,
progress in ``./<dataset>_deepv3_msgs.txt``, the test row in
``./mIoU_<n>_branches_results.csv``.  ``-G <bins>`` trains with the
sort-free histogram Lovász (kernels E and F).  Not ported yet, and raising
when asked for: ``--sp > 1`` (spatial partitioning over several devices,
ROADMAP.md queue A item 6).
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Evaluate branched deepv3.")
    p.add_argument("-t", "--type", type=str, default="resnet101")
    p.add_argument("-n", "--n_branches", type=int, default=0)
    p.add_argument("-N", "--Name", type=str, default="deep_v3_resnet101")
    p.add_argument("-p", "--print_file", type=str, default=None)
    p.add_argument("-e", "--num_epochs", type=int, default=0)
    p.add_argument("-l", "--lr", type=float, default=0.01)
    p.add_argument("-m", "--min_lr", type=float, default=0.0)
    p.add_argument("-L", "--base_lr", type=float, default=0)
    p.add_argument("-c", "--count_branches", action="store_true", default=False)
    p.add_argument("-s", "--skip", type=int, default=0)
    p.add_argument("-f", "--fine_tune", type=str, default="")
    p.add_argument("-d", "--dataset", type=str, default="voc_seg",
                   help="voc_seg (default), cityscapes, or synthetic")
    p.add_argument("-P", "--per_image_loss", action="store_true", default=False,
                   help="per-image Lovász; default is the reference's per-batch "
                        "semantics (branchy_seg_losses.py:134 per_image=False)")
    p.add_argument("-B", "--batch_loss", action="store_true", default=False,
                   help="force per-batch Lovász (the default; overrides -P)")
    p.add_argument("-K", "--max_present", type=int, default=None,
                   help="Lovász: sort/score only the K most frequent present classes "
                        "per image (exact when images have <= K present classes). "
                        "Default: all classes (exact)")
    p.add_argument("-X", "--exact_compaction", action="store_true", default=False,
                   help="with -K: stay exact always — a step whose batch exceeds K "
                        "present classes takes the all-class Lovász")
    p.add_argument("-G", "--hist_bins", type=int, default=None,
                   help="sort-free histogram Lovász with this many error buckets "
                        "(128 * a power of two, e.g. 1024): the per-class sort becomes a "
                        "histogram kernel. Approximate: per-class loss error is bounded "
                        "by error_range/bins. Default: exact sorted Lovász")
    p.add_argument("-D", "--input_dim", type=int, nargs="+", default=[256],
                   help="square side, or H W for non-square (e.g. -D 512 1024)")
    p.add_argument("-b", "--batch_size", type=int, default=32)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: split each batch into this many "
                        "micro-batches, one SGD update with the mean gradient; peak "
                        "memory scales with batch_size/accum_steps")
    p.add_argument("--seed", type=int, default=0,
                   help="init RNG seed (torch.manual_seed before the model is built)")
    p.add_argument("--sp", type=int, default=1,
                   help="spatial partitioning over several devices (not ported yet: "
                        "values > 1 raise)")
    common.add_device_flag(p)
    return p


def resolve_input_dim(dims):
    """[d] -> d; [h, w] -> (h, w) (square collapses to int)."""
    if isinstance(dims, int):
        return dims
    dims = [int(d) for d in dims]
    if len(dims) == 1 or dims[0] == dims[1]:
        return dims[0]
    return tuple(dims[:2])


def check_ported(args) -> None:
    """Raise for the options whose code paths are not ported yet."""
    if args.sp > 1:
        raise NotImplementedError(
            "--sp > 1: spatial partitioning over several devices is not ported yet "
            "(ROADMAP.md queue A item 6, multi-GPU)")


def make_dts_info(args, loss):
    """Assemble the experiment dict (main_bradeepv3.py:92-134 shape)."""
    from ee_semantic_segmentation_tpu_torch.cli.common import resolve_device
    from ee_semantic_segmentation_tpu_torch.data.loader import LoadDataset, dataset_class_info

    device = resolve_device(args.device)
    dataset = args.dataset
    og_dir = os.getcwd()
    r_dir = os.path.join(og_dir, f"{dataset}_results")
    os.makedirs(r_dir, exist_ok=True)
    data_path = os.path.join(og_dir, "datasets", dataset.split("_")[0])

    base_lr = args.base_lr
    if args.n_branches and not base_lr:
        base_lr = args.lr

    input_dim = resolve_input_dim(args.input_dim)
    n_classes, _ = dataset_class_info(dataset)
    train_set, val_set, test_set = LoadDataset(input_dim, None, None).get_dataset(
        data_path, dataset)

    return {
        "name": args.Name,
        "main_dir": og_dir,
        "res_dir": r_dir,
        "input_dim": input_dim,
        "train_set": train_set,
        "val_set": val_set,
        "test_set": test_set,
        "use_file": args.print_file or f"{dataset}_deepv3_msgs.txt",
        "metrics": ["mIoU"],
        "minimize": False,
        "n_branches": args.n_branches,
        "count_branches": args.count_branches,
        "depth": 50 if "resnet50" in args.type else 101,
        "backbone": "mobilenet_v3_large" if "mobilenet" in args.type else "resnet",
        "lr": args.lr,
        "min_lr": args.min_lr,
        "base_lr": base_lr,
        "num_epochs": args.num_epochs,
        "batch_sizes": args.batch_size,
        "loss": loss,
        "use_scheduler": True,
        "nout_channels": n_classes,
        "skip": args.skip,
        "fine_tune": args.fine_tune or None,
        "freeze_backbone": bool(args.fine_tune),
        "freeze_from": None,
        "weighted_lr": False,
        "branch_params": None,
        "accum_steps": args.accum_steps,
        "seed": args.seed,
        "device": device,
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_ported(args)
    from ee_semantic_segmentation_tpu_torch.data.loader import dataset_class_info
    from ee_semantic_segmentation_tpu_torch.ops.branchy import LovaszSoftmax
    from ee_semantic_segmentation_tpu_torch.train.trainer import eval_deepv3
    from ee_semantic_segmentation_tpu_torch.utils.logging import log_msg

    _, void = dataset_class_info(args.dataset)
    loss = LovaszSoftmax(
        classes="present", ignore=void, n_branches=args.n_branches,
        per_image=args.per_image_loss and not args.batch_loss,
        max_present=args.max_present,
        exact_fallback=args.exact_compaction,
        hist_bins=args.hist_bins,
    )
    info = make_dts_info(args, loss)
    ret = eval_deepv3(info)
    log_msg(f"Finished training. model is saved @ {ret}", info["use_file"], True)
    log_msg("-" * 20, info["use_file"], True)
    return ret


if __name__ == "__main__":
    main()
