#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ee_semantic_segmentation_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. environment: torch/CUDA/nvcc versions and the card's name and power limit;
2. build: compile the CUDA kernels from ``csrc/`` with nvcc;
3. kernel vs plain version on the card (TF32 off), at the flagship eval
   shape (N=16, 64x64 -> 512x512, C=21) and a ragged one: argmax maps,
   confusion counts and entropies must agree; kernel, plain and library
   times are medians of 20 runs timed with CUDA events;
4. main path: the flagship branchy DeepLabV3-ResNet50 at 512² with seeded
   random weights, saved as a checkpoint and evaluated through the CLIs
   ``eval_miou`` and ``eval_br_ent`` with the kernel head (launch counts
   checked) and with the plain head (results must agree), then the eval
   throughput of both evaluators over the same pre-loaded batches;
5. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "ee_semantic_segmentation_tpu_torch"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 rate and
# float32 outside the tensor cores — the kernels use FP32 FFMA only.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
C = 21
TOL_MAP_AGREE = 0.99999    # share of argmax pixels that must agree
TOL_ENT_RTOL = 1e-4        # entropy: float association and expf vs softmax+log
TOL_MIOU_ABS = 1e-4        # kernel head vs plain head, per-exit mIoU


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each between two
    CUDA events.  A sleep kernel queued first lets the host enqueue all
    runs ahead, so host launch overhead does not enter the device times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bounds_ms(N, h, w, H, W, count, esize):
    """Least time the card could take for each kernel's work at these
    inputs: max(bytes / HBM rate, operations / f32 rate).

    Bytes: each input read once, each output written once.  Operations
    (float32, one per add, multiply, compare, exp or log; an FMA is two) of
    the separable upsample: each row-interpolated value (H*w*C per image)
    and each output value (H*W*C) takes one multiply and one FMA (3), then
    one compare per output value for the argmax.  B adds per output value
    a subtract, an exp, an add and an FMA (5) and per pixel a log, a divide
    and a subtract (3).  Kernel A only touches the ``count`` valid rows."""
    up = H * w * C * 3 + H * W * C * 3 + H * W * C
    a_bytes = count * (h * w * C * esize + H * W * 4) + 3 * C * 4 + (H + W) * 16
    a_ops = count * up
    b_bytes = N * (h * w * C * esize + H * W * 4 + 4) + (H + W) * 16
    b_ops = N * (up + H * W * C * 5 + H * W * 3)
    out = {}
    for name, nbytes, ops in (("A", a_bytes, a_ops), ("B", b_bytes, b_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def kernel_vs_plain(U, torch):
    """Phase 3.  Returns per-kernel measurements at the flagship shape."""
    import numpy as np
    import torch.nn.functional as Fn

    results = {}
    cases = [("flagship", (16, 64, 64), (512, 512), 16), ("ragged", (3, 9, 13), (67, 101), 2)]
    for tag, (N, h, w), (H, W), count in cases:
        rng = np.random.RandomState(0)
        logits = torch.from_numpy((2 * rng.randn(N, h, w, C)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.randint(0, C + 1, (N, H, W)).astype(np.int32)).cuda()

        conf_k = U.upsample_argmax_confusion(logits, labels, count, (H, W))
        conf_p = U.upsample_argmax_confusion_plain(logits, labels, count, (H, W))
        maps_k, ent_k = U.upsample_entropy_argmax(logits, (H, W))
        maps_p, ent_p = U.upsample_entropy_argmax_plain(logits, (H, W))
        torch.cuda.synchronize()

        differ = maps_k != maps_p
        agree = 1.0 - differ.float().mean().item()
        n_differ_valid = int(differ[:count].sum())
        conf_err = float((conf_k - conf_p).abs().max())
        conf_l1 = float((conf_k - conf_p).abs().sum())
        ent_err = float((ent_k - ent_p).abs().max())
        ent_rel = float(((ent_k - ent_p).abs() / ent_p.abs()).max())
        print(f"[kernel-vs-plain] {tag}: N={N} {h}x{w}->{H}x{W} C={C} count={count}: "
              f"argmax agree {agree:.7f}, differing pixels {int(differ.sum())}; "
              f"confusion sum|d| {conf_l1:g} (max {conf_err:g}); entropy max|d| {ent_err:.3g} "
              f"(rel {ent_rel:.3g})")
        check(agree >= TOL_MAP_AGREE, f"{tag}: argmax maps agree on {agree:.7f} < {TOL_MAP_AGREE}")
        check(conf_l1 <= 3 * n_differ_valid,
              f"{tag}: confusion counts differ by {conf_l1} > 3 x {n_differ_valid} flipped pixels")
        check(ent_rel <= TOL_ENT_RTOL, f"{tag}: entropy rel err {ent_rel:.3g} > {TOL_ENT_RTOL}")
        if tag != "flagship":
            continue

        def library():  # yardstick: upsample + argmax only, no counts
            x = logits.permute(0, 3, 1, 2)
            return Fn.interpolate(x, size=(H, W), mode="bilinear", align_corners=False).argmax(1)

        lib_ms = median_ms(library)
        bounds = bounds_ms(N, h, w, H, W, count, logits.element_size())
        for key, fn, plain, err in (
            ("A", lambda: U.upsample_argmax_confusion(logits, labels, count, (H, W)),
             lambda: U.upsample_argmax_confusion_plain(logits, labels, count, (H, W)), conf_err),
            ("B", lambda: U.upsample_entropy_argmax(logits, (H, W)),
             lambda: U.upsample_entropy_argmax_plain(logits, (H, W)), ent_err),
        ):
            results[key] = dict(ms=median_ms(fn), plain_ms=median_ms(plain), library_ms=lib_ms,
                                bound_ms=bounds[key][0], bound_by=bounds[key][1],
                                max_abs_err=err)
            print(f"[kernel-vs-plain] {key} at {tag}: kernel {results[key]['ms']:.4f} ms, "
                  f"plain {results[key]['plain_ms']:.4f} ms, library (interpolate+argmax) "
                  f"{lib_ms:.4f} ms, bound {bounds[key][0]:.4f} ms ({bounds[key][1]})")
    return results


def read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def as_float(v: str) -> float:
    return float(v) if v != "" else float("nan")


MIOU_SCHEMA = ["net_id", "b1_mIoU", "b2_mIoU", "mIoU"]
ENT_SCHEMA = ["net_id", "b1_mIoU", "b1_count", "b2_mIoU", "b2_count", "mIoU_out",
              "count_out", "mIoU_gl", "out_gl", "t", "pool", "pool_size"]


def main_path(U, torch):
    """Phase 4.  Returns each kernel's launches on its main-path run and the
    evaluators' images/s."""
    from ee_semantic_segmentation_tpu_torch.cli import eval_br_ent, eval_miou
    from ee_semantic_segmentation_tpu_torch.cli.common import load_model, resolve_test_set
    from ee_semantic_segmentation_tpu_torch.data.loader import DataLoader
    from ee_semantic_segmentation_tpu_torch.ee.batch_eval import (
        br_evaluator_entropy_fused,
        make_kernel_miou_step_fn,
        mIoU_evaluator_fused,
    )
    from ee_semantic_segmentation_tpu_torch.models.branchy_deepv3 import build_branchy_deeplabv3
    from ee_semantic_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model = build_branchy_deeplabv3(depth=50, n=2, img_dim=512, count_branches=False)
    cfg = model.config
    check(cfg.segment_ends == (12, 15), f"flagship segment_ends {cfg.segment_ends} != (12, 15)")
    n_img, bs, tau = 16, 12, 0.5  # synthetic test split: 16 images, 2nd batch count=4
    launches, rows, ips = {}, {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(tmp, "flagship", model, cfg)
        del model
        args = ["-M", ckpt, "-c", str(C), "-D", "512", "512", "-d", "synthetic", "-b", str(bs)]
        os.chdir(tmp)
        try:
            for key, kernel, cli, extra in (
                ("miou", U.upsample_argmax_confusion, eval_miou, []),
                ("ent", U.upsample_entropy_argmax, eval_br_ent, ["-t", str(tau)]),
            ):
                for head in ("kernel", "plain"):
                    for k in U.KERNELS:
                        k.launches = 0
                    t0 = time.perf_counter()
                    cli.main(args + extra + ["-s", f"{key}_{head}"]
                             + (["--pallas_head"] if head == "kernel" else []))
                    torch.cuda.synchronize()
                    counts = {k.__name__: k.launches for k in U.KERNELS}
                    print(f"[main-path] {cli.__name__.rsplit('.', 1)[1]} {head} head: "
                          f"{time.perf_counter() - t0:.2f} s wall (load + data + eval), "
                          f"launches {counts}")
                    if head == "kernel":
                        launches[kernel.__name__] = kernel.launches
                        check(kernel.launches == 3 * 2,
                              f"{kernel.__name__} launched {kernel.launches} times, "
                              "want 3 exits x 2 batches")
                    else:
                        check(not any(counts.values()), "the plain head launched a kernel")
                    rows[key, head] = read_csv(f"{key}_{head}.csv")
                    check(len(rows[key, head]) == 1, f"{key}_{head}.csv: want one row")

            # eval throughput over the same batches, loaded once up front
            model = load_model(ckpt, torch.device("cuda"))
            batches = list(DataLoader(resolve_test_set("synthetic", 512), bs))
            runs = {
                "eval_miou kernel head": lambda: mIoU_evaluator_fused(
                    model, 3, C, batches, step=make_kernel_miou_step_fn(model, C)),
                "eval_miou plain head": lambda: mIoU_evaluator_fused(model, 3, C, batches),
                "eval_br_ent kernel head": lambda: br_evaluator_entropy_fused(
                    model, 3, C, batches, tau, pallas_head=True),
                "eval_br_ent plain head": lambda: br_evaluator_entropy_fused(
                    model, 3, C, batches, tau),
            }
            for name, fn in runs.items():
                fn()  # warm-up (cuDNN algorithm choice, allocator)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ips[name] = n_img / (time.perf_counter() - t0)
                print(f"[main-path] {name}: {ips[name]:.2f} images/s "
                      f"({n_img} images at 512x512, batch {bs}, evaluator over pre-loaded batches)")

            # tau 0.5 sends every image of the random model to the final
            # head; a tau in the widest gap between two first-exit entropies
            # splits the images, so the gated buckets get checked too
            with torch.inference_mode():
                ent1 = torch.cat([
                    U.upsample_entropy_argmax(
                        model.lowres_logits(torch.from_numpy(b["image"]).cuda())[0],
                        (512, 512))[1][:b["count"]]
                    for b in batches]).sort().values.tolist()
            gap, i = max((ent1[j + 1] - ent1[j], j) for j in range(len(ent1) - 1))
            check(gap > 1e-5, f"first-exit entropies too close to split: {ent1}")
            tau_split = (ent1[i] + ent1[i + 1]) / 2
            split_k = br_evaluator_entropy_fused(model, 3, C, batches, tau_split, pallas_head=True)
            split_p = br_evaluator_entropy_fused(model, 3, C, batches, tau_split)
            print(f"[main-path] first-exit entropies {[round(e, 6) for e in ent1]}; "
                  f"tau {tau_split:.6f}: kernel head {split_k}, plain head {split_p}")
            check(split_k["b1_count"] == i + 1, f"tau split: b1_count {split_k['b1_count']} != {i + 1}")
            for col, a in split_k.items():
                b = split_p[col]
                check(a == b if isinstance(a, (int, str)) else
                      (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
                      f"tau split {col}: kernel head {a} vs plain head {b}")
        finally:
            os.chdir(cwd)

    for key, schema in (("miou", MIOU_SCHEMA), ("ent", ENT_SCHEMA)):
        for head in ("kernel", "plain"):
            check(list(rows[key, head][0]) == schema,
                  f"{key} {head} CSV schema {list(rows[key, head][0])} != {schema}")
    for col in ("b1_mIoU", "b2_mIoU", "mIoU"):
        a, b = as_float(rows["miou", "kernel"][0][col]), as_float(rows["miou", "plain"][0][col])
        print(f"[main-path] eval_miou {col}: kernel head {a!r}, plain head {b!r}")
        check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
              f"eval_miou {col}: kernel head {a} vs plain head {b}")
    gk, gp = rows["ent", "kernel"][0], rows["ent", "plain"][0]
    print(f"[main-path] eval_br_ent kernel head row {dict(gk)}")
    print(f"[main-path] eval_br_ent plain head row  {dict(gp)}")
    for g in (gk, gp):
        exits = int(g["b1_count"]) + int(g["b2_count"]) + int(g["count_out"])
        check(exits == n_img and int(g["out_gl"]) == n_img,
              f"exit counts sum to {exits} (out_gl {g['out_gl']}), want {n_img}")
    for col in ("b1_count", "b2_count", "count_out", "out_gl"):
        check(gk[col] == gp[col], f"eval_br_ent {col}: kernel head {gk[col]} vs plain head {gp[col]}")
    for col in ("b1_mIoU", "b2_mIoU", "mIoU_out", "mIoU_gl"):
        a, b = as_float(gk[col]), as_float(gp[col])
        check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL_MIOU_ABS,
              f"eval_br_ent {col}: kernel head {a} vs plain head {b}")
    return launches, ips


KERNEL_INFO = (
    ("A", "upsample_argmax_confusion", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:441"),
    ("B", "upsample_entropy_argmax", "ee_semantic_segmentation_tpu/ops/pallas/upsample_argmax.py:284"),
)


def main() -> int:
    # ---------------------------------------------------------------- phase 1
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside {__file__}; run from a checkout",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ee_semantic_segmentation_tpu_torch.ops.kernels import _build
    from ee_semantic_segmentation_tpu_torch.ops.kernels import upsample_argmax as U

    nvcc = _build.find_nvcc()
    nvcc_version = run([nvcc, "--version"]).splitlines()[-1] if nvcc else "nvcc not found"
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {nvcc_version}, {torch.cuda.get_device_name(0)}")
    print(card.splitlines()[0])

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    log = so.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- phase 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    measured = kernel_vs_plain(U, torch)
    # the main path runs with PyTorch's defaults, as a user's CLI call does
    torch.backends.cudnn.allow_tf32 = True

    # ---------------------------------------------------------------- phase 4
    launches, ips = main_path(U, torch)

    # ---------------------------------------------------------------- phase 5
    kernels = []
    for key, name, replaces in KERNEL_INFO:
        m = measured[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/ops/kernels/csrc/upsample_heads.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "kernel_ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "card": card.splitlines()[0], "eval_images_per_s": ips}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
