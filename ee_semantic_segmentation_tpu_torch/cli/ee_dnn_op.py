"""Early-exit engine CLI, similarity gate -> appended CSV.

Port of ``ee_semantic_segmentation_tpu/cli/ee_dnn_op.py``: the same flags
plus ``--device``, the same row (exit histogram ``e_{i}``/``out``,
``avg_flops``/``edge_flops`` and their ``_2`` variants that leave out the
first branch head, ``ig_bk``, the union-based ``mIoU``) appended to
``./ee_{n}_{metric}_lw_m2_res.csv``.  ``--engine seq`` (the default) runs
``ee/sequential.EarlyExitRunner`` image by image; ``--engine masked`` runs
``ee/masked.make_masked_gated_apply`` over micro-batches of ``-b``, under
``torchrun`` data-parallel (each rank runs its rows of every micro-batch;
the sequential engine takes one image at a time and runs in one process
only).  Run as

    python -m ee_semantic_segmentation_tpu_torch.cli.ee_dnn_op -M <ckpt> \\
        -m ssim -t 0.5 -i -s 512 512 -d synthetic -n 21 --engine masked -b 12
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch


class union_mIoU:
    """The ee_dnn_op.py:20-38 accumulator: per class, the sum of
    intersections over the sum of unions of all images (union = pixels
    where prediction or truth is the class).  A pixel whose label is void
    (outside ``[0, C)``) still counts in the union of the class it is
    predicted as.  The counts come from one ``bincount`` of (prediction,
    label) pairs on the maps' device."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.acc = None  # (2, C) int64: intersections, unions

    def __call__(self, pred_map, gt):
        pred = torch.as_tensor(pred_map)
        gt = torch.as_tensor(gt).to(pred.device)
        C, K = self.n_classes, self.n_classes + 1
        pred, gt = pred.reshape(-1).long(), gt.reshape(-1).long()
        pred = torch.where((pred >= 0) & (pred < C), pred, C)
        gt = torch.where((gt >= 0) & (gt < C), gt, C)
        joint = torch.bincount(pred * K + gt, minlength=K * K).reshape(K, K)
        inter = joint.diagonal()[:C]
        union = joint[:C].sum(dim=1) + joint[:, :C].sum(dim=0) - inter
        counts = torch.stack([inter, union])
        self.acc = counts if self.acc is None else self.acc + counts

    def compute(self):
        acc = (np.zeros((2, self.n_classes)) if self.acc is None
               else self.acc.double().cpu().numpy())
        with np.errstate(invalid="ignore", divide="ignore"):
            ciou = acc[0] / acc[1]
        return float(np.nansum(ciou) / self.n_classes)


def build_parser(entropy: bool = False):
    from ee_semantic_segmentation_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="Evaluate EE-DNN.")
    p.add_argument("-M", "--model")
    p.add_argument("-m", "--metric")
    p.add_argument("-t", "--threshold", type=float)
    if not entropy:
        p.add_argument("-i", "--ignore_background", action="store_true", default=False)
    p.add_argument("-I", "--ignore_branch", nargs="+", type=int, default=[])
    p.add_argument("-v", "--verbose", action="store_true", default=False)
    p.add_argument("-s", "--size", type=int, nargs="+", default=[256, 256])
    p.add_argument("-d", "--dataset", type=str, default=None)
    p.add_argument("-n", "--n_classes", type=int)
    p.add_argument("-p", "--pool_size", type=int, default=1)
    p.add_argument("--engine", choices=["seq", "masked"], default="seq",
                   help="seq = one image at a time, segment by segment (reference "
                        "semantics); masked = micro-batches of -b (ee/masked.py): a "
                        "segment is skipped once every image of the micro-batch has "
                        "exited")
    p.add_argument("-b", "--batch_size", type=int, default=8,
                   help="micro-batch size for --engine masked")
    p.add_argument("-S", "--skip", type=int, default=0,
                   help="--engine masked: leave the first S branches "
                        "ungated (equivalent to a leading -I 1..S)")
    if entropy:
        p.add_argument("--pallas_head", action="store_true", default=False,
                       help="masked engine: the fused CUDA upsample+entropy+argmax "
                            "gate head (kernel B) and upsample+argmax final head "
                            "(kernel C); -m ent without pooling only")
    common.add_device_flag(p)
    return p


def run_masked(args, entropy: bool):
    """Micro-batched masked-engine path (entropy or similarity gate); the
    same CSV row as the sequential path.  The FLOPs are the analytic
    table's over the exit histogram (the masked engine really skips the
    segments after the micro-batch's last exit)."""
    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.masked import (
        gated_flops_per_image,
        make_masked_gated_apply,
    )

    metric = args.metric.lower()
    skip = args.skip
    ig = sorted(args.ignore_branch)
    if ig:
        # a leading -I prefix IS a skip; anything else cannot be expressed
        # at a fixed batch shape (every gated branch head runs)
        if ig != list(range(1, len(ig) + 1)):
            raise SystemExit(
                "--engine masked supports only a leading -I prefix "
                "(e.g. -I 1 2), which is equivalent to -S")
        skip = max(skip, len(ig))

    n_classes = args.n_classes
    ignore_bk = getattr(args, "ignore_background", False)
    sim_ignore = () if entropy else (
        (0, n_classes - 1) if ignore_bk else (n_classes - 1,))
    pool = {"max": "max", "min": "min"}.get(metric, "none") if entropy else "none"

    device, mesh = common.resolve_device_and_mesh(args.device)
    model = common.load_model(args.model, device)
    n_eexits = model.config.n_branches
    img_size = args.size
    input_dim = img_size[0]

    pallas_head = getattr(args, "pallas_head", False)
    fn = make_masked_gated_apply(
        model, tau=args.threshold, n_classes=n_classes, skip=skip,
        pool=pool, pool_size=args.pool_size, pallas_head=pallas_head,
        metric="ent" if entropy else metric, sim_ignore=sim_ignore, mesh=mesh,
    )
    say = print if common.is_primary() else (lambda *a: None)
    if fn.kernel_head:
        say("masked engine: kernel head (upsample_entropy_argmax at each gated branch, "
              "upsample_argmax at the final classifier)")
    else:
        say("masked engine: plain head" + (
            " (--pallas_head takes the kernel head only for -m ent without pooling)"
            if pallas_head else ""))
    test_set = common.resolve_test_set(args.dataset, input_dim)
    loader = DataLoader(test_set, args.batch_size)

    prog = union_mIoU(n_classes)
    exit_counts: dict = {}
    n_imgs = 0
    for batch in loader:
        count = int(batch.get("count", len(batch["image"])))
        images = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32))
        # with a mesh the engine moves this rank's rows to its GPU
        labels, exits = fn(images if mesh is not None else images.to(device))
        prog(labels[:count], torch.from_numpy(np.asarray(batch["label"][:count])))
        for e, c in zip(*np.unique(exits[:count].cpu().numpy(), return_counts=True)):
            exit_counts[int(e)] = exit_counts.get(int(e), 0) + int(c)
        n_imgs += count

    table = model.flops_table(input_dim)

    def edge_avg(exclude_first):
        # edge = compute spent on the device before offloading: the gated
        # cost for images that exited, everything up to the last branch else
        first = skip + 1 if exclude_first else skip
        edge_cost = (sum(table["segments"][:-1])
                     + sum(table["branches"][first:-1]))
        tot = sum(
            (gated_flops_per_image(model, {e: 1}, skip=skip, img_dim=input_dim,
                                   exclude_first_branch=exclude_first)
             if e <= n_eexits else edge_cost) * c
            for e, c in exit_counts.items()
        )
        return tot / max(n_imgs, 1)

    res = defaultdict(list)
    res["net_id"].append(args.model)
    res["x"].append(img_size[0])
    res["y"].append(img_size[1] if len(img_size) > 1 else img_size[0])
    res["metric"].append(metric)
    res["t"].append(args.threshold)
    for i in range(n_eexits):
        res[f"e_{i + 1}"].append(exit_counts.get(i + 1, 0))
    res["out"].append(exit_counts.get(n_eexits + 1, 0))
    res["n_imgs"].append(n_imgs)
    res["avg_flops"].append(
        gated_flops_per_image(model, exit_counts, skip=skip, img_dim=input_dim)
    )
    res["edge_flops"].append(edge_avg(False))
    if not entropy:
        res["avg_flops_2"].append(gated_flops_per_image(
            model, exit_counts, skip=skip, img_dim=input_dim,
            exclude_first_branch=True))
        res["edge_flops_2"].append(edge_avg(True))
        res["ig_bk"].append(ignore_bk)
    res["mIoU"].append(prog.compute())

    saveat = f"./ee_{n_eexits}_{metric}_lw_m2_res.csv"
    common.append_csv(dict(sorted(res.items())), saveat)


def run(args, entropy: bool):
    from ee_semantic_segmentation_tpu_torch.cli import common
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.sequential import EarlyExitRunner

    if getattr(args, "engine", "seq") == "masked":
        return run_masked(args, entropy)
    if common.launched():
        raise SystemExit("--engine seq runs one image at a time in one process; under "
                         "torchrun use --engine masked")

    n_classes = args.n_classes
    metric = args.metric
    ignore_bk = getattr(args, "ignore_background", False)
    sim_ignore = (0, n_classes - 1) if ignore_bk else (n_classes - 1,)

    ig_br = sorted(i - 1 for i in args.ignore_branch)

    device = common.resolve_device(args.device)
    model = common.load_model(args.model, device)
    n_eexits = model.config.n_branches

    img_size = args.size
    input_dim = img_size[0]
    runner = EarlyExitRunner(
        model,
        metric=metric, threshold=args.threshold,
        less_than=metric.lower() not in ("ssim", "nmi") if not entropy else True,
        ignore=ig_br, n_classes=n_classes, pool_size=args.pool_size,
        sim_ignore=sim_ignore, img_dim=input_dim,
    )

    test_set = common.resolve_test_set(args.dataset, input_dim)
    loader = DataLoader(test_set, 1, pad_final=False)

    res = defaultdict(list)
    res["net_id"].append(args.model)
    res["x"].append(img_size[0])
    res["y"].append(img_size[1] if len(img_size) > 1 else img_size[0])
    res["metric"].append(metric.lower())
    res["t"].append(args.threshold)

    tot = tot2 = edge = edge2 = 0.0
    n_imgs = 0
    prog = union_mIoU(n_classes)
    if args.verbose:
        print(f"Started EE-DNN evaluation.\n\tmodel: {args.model}")
    for batch in loader:
        if n_imgs % 50 == 0 and args.verbose:
            print(f"\tprocessed {n_imgs} images")
        out = runner(batch["image"][0])
        tot += out["exit_flops"]
        edge += out["edge_flops"]
        tot2 += out.get("exit_flops_2", 0.0)
        edge2 += out.get("edge_flops_2", 0.0)
        n_imgs += 1
        prog(out["exit"], torch.from_numpy(np.asarray(batch["label"][0])))
        n_exit = out["n"]
        label = "out" if n_exit == n_eexits + 1 else f"e_{n_exit}"
        if label in res:
            res[label][0] += 1
        else:
            res[label].append(1)

    for i in range(n_eexits):
        res.setdefault(f"e_{i + 1}", [0])
    res.setdefault("out", [0])
    res["n_imgs"].append(n_imgs)
    res["avg_flops"].append(tot / max(n_imgs, 1))
    res["edge_flops"].append(edge / max(n_imgs, 1))
    if not entropy:
        res["avg_flops_2"].append(tot2 / max(n_imgs, 1))
        res["edge_flops_2"].append(edge2 / max(n_imgs, 1))
        res["ig_bk"].append(ignore_bk)
    res["mIoU"].append(prog.compute())

    saveat = f"./ee_{n_eexits}_{metric}_lw_m2_res.csv"
    common.append_csv(dict(sorted(res.items())), saveat)
    if args.verbose:
        print("...done")


def main(argv=None):
    args = build_parser(entropy=False).parse_args(argv)
    run(args, entropy=False)


if __name__ == "__main__":
    main()
