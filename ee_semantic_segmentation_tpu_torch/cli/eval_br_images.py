"""Similarity-gated policy evaluation with per-image mIoU accumulators.

Port of ``ee_semantic_segmentation_tpu/cli/eval_br_images.py``: the flags of
``eval_br_sim`` (``--pallas_head`` has no effect here, as in the JAX
package), accumulators ``img_mIoU`` (eval_br_images.py:17).  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.eval_br_images -M <ckpt> \\
        -c 21 -D 512 512 -d synthetic -b 12 -m nmi -t 0.5
"""

from ee_semantic_segmentation_tpu_torch.cli.eval_br_sim import main as _main


def main(argv=None):
    return _main(argv, image_level=True)


if __name__ == "__main__":
    main()
