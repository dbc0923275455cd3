"""Export a checkpoint as a self-contained serving artifact.

Port of ``tools/export_serving.py``: the eval forward (``--head logits``)
or the whole gated early-exit engine (``--head gated``) is traced by
``torch.export`` with the checkpoint's weights in it and saved as
``<out>.pt2`` + ``<out>.json`` (``ee/aot.py``).  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.export_serving \\
        -M run/demo -b 8 -o run/demo_serving
    python -m ee_semantic_segmentation_tpu_torch.cli.export_serving \\
        -M run/demo -b 8 --head gated -t 0.3 --pallas_head -o run/demo_gated

and serve with ``torch`` alone (plus ``ops/kernels/upsample_argmax`` for
the kernel head)::

    from ee_semantic_segmentation_tpu_torch.ee.aot import load_exported
    logits = load_exported("run/demo_serving").module()(images)   # (E, N, H, W, C)

The program runs on the device it was exported on (``--device``).  The JAX
tool's ``--bf16`` and ``--platforms`` have no counterpart: the port's model
computes in float32, and a program is traced for one device.
"""

from __future__ import annotations

import argparse


def build_parser():
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Export a serving artifact.")
    p.add_argument("-M", "--model", required=True,
                   help="checkpoint path (with .json config sidecar)")
    p.add_argument("-o", "--out", required=True, help="artifact path prefix")
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--symbolic_batch", action="store_true", default=False,
                   help="export a SYMBOLIC batch dimension: one artifact serves any "
                        "batch size; ignores -b")
    p.add_argument("--head", choices=("logits", "gated"), default="logits",
                   help="'logits': stacked all-exit forward; 'gated': the masked "
                        "early-exit engine (labels + exit index)")
    p.add_argument("-t", "--threshold", type=float, default=0.3,
                   help="gate threshold (gated head)")
    p.add_argument("-m", "--metric", type=str, default="ent",
                   help="gate metric: ent or a similarity name (gated head)")
    p.add_argument("-I", "--skip", type=int, default=0)
    p.add_argument("-c", "--n_classes", type=int, default=21)
    p.add_argument("--pallas_head", action="store_true", default=False,
                   help="gated head with the entropy gate: kernel B at each gated branch "
                        "and kernel C at the final classifier (fixed batch only)")
    common.add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_device
    from ee_semantic_segmentation_tpu_torch.ee.aot import (
        export_eval_forward,
        export_gated,
        save_exported,
    )

    model = load_model(args.model, resolve_device(args.device))
    batch = None if args.symbolic_batch else args.batch_size
    meta = {
        "checkpoint": args.model,
        "head": args.head,
        "batch_size": "symbolic" if batch is None else batch,
        "n_exits": model.config.n_branches + 1,
    }
    if args.head == "gated":
        ep = export_gated(model, batch, tau=args.threshold, metric=args.metric,
                          skip=args.skip, n_classes=args.n_classes,
                          pallas_head=args.pallas_head)
        meta.update(tau=args.threshold, metric=args.metric, skip=args.skip,
                    pallas_head=args.pallas_head)
    else:
        ep = export_eval_forward(model, batch)
    path = save_exported(ep, args.out, meta)
    print(f"exported {args.head} head on {args.device} -> {path}")
    return path


if __name__ == "__main__":
    main()
