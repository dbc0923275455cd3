"""Train branchy DeepLabV3 with multi-exit pixelwise cross-entropy.

Port of ``ee_semantic_segmentation_tpu/cli/main_bradeepv3_ce.py``: the
Lovász CLI (``cli/main_bradeepv3.py``, same flags) with the loss
``BrXEntropyLoss(ignore_index=void, b_reduction='sum',
n_exits=n_branches+1)`` (main_bradeepv3_ce.py:121).  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.main_bradeepv3_ce \\
        -t resnet50 -n 2 -D 512 -b 16 -e 1 -d synthetic -l 0.01
"""

from __future__ import annotations


def main(argv=None):
    from ee_semantic_segmentation_tpu_torch.cli.main_bradeepv3 import (
        build_parser,
        check_ported,
        make_dts_info,
    )
    from ee_semantic_segmentation_tpu_torch.data.loader import dataset_class_info
    from ee_semantic_segmentation_tpu_torch.ops.xentropy import BrXEntropyLoss
    from ee_semantic_segmentation_tpu_torch.train.trainer import eval_deepv3
    from ee_semantic_segmentation_tpu_torch.utils.logging import log_msg

    args = build_parser().parse_args(argv)
    check_ported(args)
    _, void = dataset_class_info(args.dataset)
    loss = BrXEntropyLoss(ignore_index=void, b_reduction="sum", n_exits=args.n_branches + 1)
    info = make_dts_info(args, loss)
    ret = eval_deepv3(info)
    log_msg(f"Finished training. model is saved @ {ret}", info["use_file"], True)
    log_msg("-" * 20, info["use_file"], True)
    return ret


if __name__ == "__main__":
    main()
