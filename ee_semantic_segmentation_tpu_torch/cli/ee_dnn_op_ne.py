"""Early-exit engine CLI, normalized-entropy gate -> appended CSV.

Port of ``ee_semantic_segmentation_tpu/cli/ee_dnn_op_ne.py``: the gate is
the image's mean normalized entropy of the exit's softmax < threshold
(``-m ent``), or of its max/min block pooling (``-m max|min -p size``).
The row has the exit histogram, ``avg_flops``, ``edge_flops`` and ``mIoU``
(no ``_2`` columns, as in the reference).  ``--engine masked
--pallas_head`` runs kernels B and C in the masked engine.  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.ee_dnn_op_ne -M <ckpt> \\
        -m ent -t 0.9 -s 512 512 -d synthetic -n 21 --engine masked -b 12 --pallas_head
"""

from __future__ import annotations

from ee_semantic_segmentation_tpu_torch.cli.ee_dnn_op import build_parser, run


def main(argv=None):
    args = build_parser(entropy=True).parse_args(argv)
    if args.metric is None:
        args.metric = "ent"
    if args.metric.lower() not in ("ent", "max", "min"):
        raise ValueError(f"-m must be one of ent, max, min; got {args.metric!r}")
    run(args, entropy=True)


if __name__ == "__main__":
    main()
